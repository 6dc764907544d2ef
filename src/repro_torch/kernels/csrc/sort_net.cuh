// A per-thread sort of W register slots and the reductions read off it:
// the one network the f32 sort (f32_agg.cu) and the fused int8
// aggregation (fused_agg.cu) share.
//
// Batcher's odd-even merge sort of W slots (W a power of two, at most 32:
// 19, 63 or 191 compare-exchanges) as fminf / fmaxf at compile-time
// indices.  The caller fills slots K..W-1 with +inf (FLT_MAX where every
// value is finite), which sort last.  The
// network has no branches, so the lanes of a warp never diverge, and it
// touches no shared memory.  The readers take the slot at a run-time
// position through log2(W) levels of selects, or walk every slot with a
// mask, so no slot is ever indexed at run time and the array stays in
// registers (ptxas -v: 0 bytes stack, 0 spills; chip_smoke.py checks).  The
// median of a full network (K == W, the round's k = 8 on W = 8) reads its
// middle pair at constant indices.
//
// Numerics follow the reference as compiled: the median of an even count
// is 0.5 * (a + b); the trimmed mean is the sequential sum of the kept
// sorted values times f32(1 / kept).  The sum starts at -0.0 and adds
// -0.0 for every slot it skips: x + -0.0 == x for every x, +0.0 and -0.0
// included, so it equals the reference's sum that starts at the first
// kept value.
#pragma once

#include <utility>

namespace repro {

constexpr int CWMED = 1, TRIMMED_MEAN = 2;

// The slot widths of the network: the smallest that holds K, or 0 when K
// is too deep for registers.
__host__ __device__ constexpr int network_width(int K) {
  return K <= 8 ? 8 : K <= 16 ? 16 : K <= 32 ? 32 : 0;
}

struct Network {
  int n;
  int lo[191], hi[191];  // 191 pairs sort 32 slots
};

template <int W>
__host__ __device__ constexpr Network make_network() {
  static_assert(W <= 32, "the pair table holds a 32-slot network");
  Network net{};
  for (int p = 1; p < W; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < W; j += 2 * k)
        for (int i = 0; i < k && i + j + k < W; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.lo[net.n] = i + j;
            net.hi[net.n] = i + j + k;
            ++net.n;
          }
  return net;
}

template <int W>
struct SortNetwork {
  static constexpr Network net = make_network<W>();
};

template <int A, int B, int W>
__device__ __forceinline__ void compare_exchange(float (&v)[W]) {
  const float lo = fminf(v[A], v[B]);
  v[B] = fmaxf(v[A], v[B]);
  v[A] = lo;
}

// Every pair's indices are template arguments: constant by construction.
template <int W, int... C>
__device__ __forceinline__ void sort_slots(float (&v)[W],
                                           std::integer_sequence<int, C...>) {
  (compare_exchange<SortNetwork<W>::net.lo[C], SortNetwork<W>::net.hi[C]>(v),
   ...);
}

template <int W>
__device__ __forceinline__ void sort_slots(float (&v)[W]) {
  sort_slots(v, std::make_integer_sequence<int, SortNetwork<W>::net.n>{});
}

// v[i] for a run-time 0 <= i < W: each level keeps, of each pair of
// survivors, the one the low bit of i names, and passes on i >> 1.
template <int W>
__device__ __forceinline__ float slot_at(const float (&v)[W], int i) {
  if constexpr (W == 1) {
    return v[0];
  } else {
    float t[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) t[j] = (i & 1) ? v[2 * j + 1] : v[2 * j];
    return slot_at(t, i >> 1);
  }
}

// Median of the K sorted values in slots 0..K-1.
template <int W>
__device__ __forceinline__ float median_of_slots(const float (&v)[W], int K) {
  if (K == W) return __fmul_rn(0.5f, __fadd_rn(v[W / 2 - 1], v[W / 2]));
  const float hi = slot_at(v, K / 2);
  if (K & 1) return hi;
  return __fmul_rn(0.5f, __fadd_rn(slot_at(v, K / 2 - 1), hi));
}

// Trimmed mean of the K sorted values in slots 0..K-1: the slots
// [trim, K - trim) summed in order, times inv_keep = f32(1 / (K - 2 trim)).
// Every slot is added, the ones outside the kept range as -0.0.
template <int W>
__device__ __forceinline__ float trimmed_mean_of_slots(const float (&v)[W],
                                                       int K, int trim,
                                                       float inv_keep) {
  const unsigned keep = static_cast<unsigned>(K - 2 * trim);
  float sum = -0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k)
    sum = __fadd_rn(sum, static_cast<unsigned>(k - trim) < keep ? v[k] : -0.0f);
  return __fmul_rn(sum, inv_keep);
}

// 1.0 for each sorted slot [trim, K - trim) a trimmed mean keeps, 0.0 for
// the others.  Passed to a kernel by value, so the weights are read from
// the constant bank: no register and no instruction a slot.
struct KeptSlots {
  float w[32];
};

inline KeptSlots kept_slots(int K, int trim) {
  KeptSlots kept{};
  for (int k = 0; k < 32; ++k)
    kept.w[k] = static_cast<unsigned>(k - trim) < static_cast<unsigned>(K - 2 * trim)
                    ? 1.0f : 0.0f;
  return kept;
}

// The trimmed mean for slots that are all finite and never -0.0 (the
// fused int8 kernel's q * s, padded with FLT_MAX), one fused multiply-add a
// slot: sum = fma(v[k], kept[k], sum) from +0.0.  A kept slot adds exactly
// as __fadd_rn does; a skipped one adds +-0.0, which leaves a sum that is
// never -0.0 as it was, so the sum is the reference's from its first kept
// value.
template <int W>
__device__ __forceinline__ float trimmed_mean_of_finite_slots(
    const float (&v)[W], const KeptSlots& kept, float inv_keep) {
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k) sum = __fmaf_rn(v[k], kept.w[k], sum);
  return __fmul_rn(sum, inv_keep);
}

}  // namespace repro
