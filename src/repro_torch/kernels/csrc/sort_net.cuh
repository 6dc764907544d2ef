// A per-thread sort of W register slots and the reductions read off it,
// and the merge of sorted runs of 32 for deeper columns: the device code
// the f32 sort (f32_agg.cu) and the fused int8 aggregation (fused_agg.cu)
// share.
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
// Deeper columns (33 <= K <= MERGE_MAX_K): each lane's K values are cut
// into R = ceil(K / 32) runs of 32, each sorted in registers by the
// narrowest network that holds it and stored to the lane's column of
// shared memory, then the R runs are merged by their heads in ascending
// order (merge_reduce): R - 1 compares and selects a step, one shared load,
// no data-dependent branch.  The median stops at rank K / 2; the trimmed
// mean adds ranks [trim, K - trim) as the merge yields them, so the sorted
// column is never stored whole.  About K log K work a lane, against the
// K^2 / 4 shifts of the insertion sort it replaced.
//
// Numerics follow the reference as compiled: the median of an even count
// is 0.5 * (a + b); the trimmed mean is the sequential sum of the kept
// sorted values times f32(1 / kept).  The sum starts at -0.0 and adds
// -0.0 for every slot it skips: x + -0.0 == x for every x, +0.0 and -0.0
// included, so it equals the reference's sum that starts at the first
// kept value.  Order statistics do not depend on how the column is
// sorted, so every design gives the same median and the same kept values.
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

template <int A, int B, int N>
__device__ __forceinline__ void compare_exchange(float (&v)[N]) {
  const float lo = fminf(v[A], v[B]);
  v[B] = fmaxf(v[A], v[B]);
  v[A] = lo;
}

// Every pair's indices are template arguments: constant by construction.
template <int W, int N, int... C>
__device__ __forceinline__ void sort_first(float (&v)[N],
                                           std::integer_sequence<int, C...>) {
  (compare_exchange<SortNetwork<W>::net.lo[C], SortNetwork<W>::net.hi[C]>(v),
   ...);
}

// Sorts slots 0..W-1 of an array of N >= W slots.
template <int W, int N>
__device__ __forceinline__ void sort_first(float (&v)[N]) {
  static_assert(W <= N, "the network is wider than the array");
  sort_first<W>(v, std::make_integer_sequence<int, SortNetwork<W>::net.n>{});
}

template <int W>
__device__ __forceinline__ void sort_slots(float (&v)[W]) {
  sort_first<W>(v);
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

// ---------------------------------------------------------------------
// Runs of 32 merged through shared memory.
// ---------------------------------------------------------------------
constexpr int RUN = 32;             // values a run
constexpr int RUN_SLOTS = RUN + 1;  // and a sentinel after them
constexpr int MERGE_MAX_RUNS = 4;
constexpr int MERGE_MAX_K = RUN * MERGE_MAX_RUNS;  // 128
// One lane a thread, T threads a block; a lane's column is R * RUN_SLOTS
// keys, slot k of thread t at col[k * T + t], so a warp's stores of one
// slot hit 32 banks, and so do its loads of 32 different slots.
constexpr int MERGE_THREADS = 128;

// The designs a K-row sort takes, as the C entries report them (their
// `path` argument): a register network of W slots (network_width), R runs
// merged (merge_runs) or the shared-memory insertion sort, the path above
// MERGE_MAX_K.  A C entry's `insertion` flag takes the insertion sort at
// any K, to time it beside the design the shape picks (chip_smoke.py).
constexpr int NETWORK = 1, RUN_MERGE = 2, INSERTION = 3;

__host__ __device__ constexpr int merge_runs(int K) {
  return K > RUN && K <= MERGE_MAX_K ? (K + RUN - 1) / RUN : 0;
}

struct SortPath {
  int design, size;  // size: W slots, R runs, 0 for the insertion sort
};

// The design a C entry takes for a K-row sort.
__host__ __device__ constexpr SortPath sort_path(int K, bool insertion) {
  if (insertion) return {INSERTION, 0};
  if (network_width(K) != 0) return {NETWORK, network_width(K)};
  if (merge_runs(K) != 0) return {RUN_MERGE, merge_runs(K)};
  return {INSERTION, 0};
}

__host__ __device__ constexpr int merge_smem_bytes(int R, int threads) {
  return R * RUN_SLOTS * threads * 4;
}

// How a run's values are stored and compared.  FloatKey: the value itself,
// for columns without -0.0 (the fused kernel's q * s).  OrderedKey: the
// f32 bits mapped so that signed integer order is the value order with
// -0.0 below +0.0, as the networks' fminf / fmaxf order them, so runs that
// hold ties of +0.0 and -0.0 merge into one sequence sorted as each run
// is.  end() is the sentinel after a run's last slot, above every value.
struct FloatKey {
  using T = float;
  __device__ static float end() { return __int_as_float(0x7f800000); }
  __device__ static float of(float v) { return v; }
  __device__ static float value(float k) { return k; }
};

struct OrderedKey {
  using T = int;
  __device__ static int end() { return 0x7fffffff; }
  __device__ static int of(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ static float value(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  }
};

// Copies from device memory to shared memory that complete while the
// thread goes on (Ampere's cp.async): a lane's whole column is asked for at
// once, not 32 rows at a time, so enough bytes are in flight to cover the
// memory's latency, one commit group a run, so that a run can be sorted
// while the later ones arrive.  async_copies_wait(n) waits until at most n
// of the thread's groups are in flight.
__device__ __forceinline__ void async_copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void async_copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void async_copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_copies_wait(int pending) {
  static_assert(MERGE_MAX_RUNS == 4, "a wait for every count of later runs");
  switch (pending) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// Sorts the first n values of a run (slots n..RUN-1 hold a pad that sorts
// last) by the narrowest network that holds them.  Every lane of a launch
// has the same n, so the branch never diverges.
__device__ __forceinline__ void sort_run(float (&v)[RUN], int n) {
  if (n <= 8)
    sort_first<8>(v);
  else if (n <= 16)
    sort_first<16>(v);
  else
    sort_first<RUN>(v);
}

// Stores a sorted run and its sentinel to slots 0..RUN of `run` (stride T).
template <typename Key, int T>
__device__ __forceinline__ void store_run(typename Key::T* run,
                                          const float (&v)[RUN]) {
#pragma unroll
  for (int k = 0; k < RUN; ++k) run[k * T] = Key::of(v[k]);
  run[RUN * T] = Key::end();
}

// The median (method CWMED) or the trimmed mean of a lane's K values from
// its R sorted runs in `col` (run r at slots r * RUN_SLOTS .., stride T).
// The R runs' heads are kept sorted in registers with their slots: a step
// takes the least, loads the next slot of its run and inserts that value
// among the other R - 1 heads (R - 1 compares, 2 (R - 1) selects of values
// and of slots).  A run's sentinel is never taken: while fewer than K
// values have been taken some head is a value, below end().
template <int R, typename Key, int T>
__device__ __forceinline__ float merge_reduce(const typename Key::T* col,
                                              int K, int method, int trim,
                                              float inv_keep) {
  using V = typename Key::T;
  V h[R];
  int at[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    at[r] = r * RUN_SLOTS * T;
    h[r] = col[at[r]];
  }
#pragma unroll
  for (int i = 1; i < R; ++i)
#pragma unroll
    for (int j = i; j > 0; --j) {
      const bool swap = h[j] < h[j - 1];
      const V lo = swap ? h[j] : h[j - 1], hi = swap ? h[j - 1] : h[j];
      const int alo = swap ? at[j] : at[j - 1], ahi = swap ? at[j - 1] : at[j];
      h[j - 1] = lo;
      h[j] = hi;
      at[j - 1] = alo;
      at[j] = ahi;
    }
  auto next = [&]() {
    const V m = h[0];
    const int an = at[0] + T;
    const V n = col[an];
    bool below[R];  // below[k]: head k stays ahead of n (below[0]: taken)
    below[0] = true;
#pragma unroll
    for (int k = 1; k < R; ++k) below[k] = h[k] < n;
#pragma unroll
    for (int k = 0; k + 1 < R; ++k) {
      h[k] = below[k + 1] ? h[k + 1] : below[k] ? n : h[k];
      at[k] = below[k + 1] ? at[k + 1] : below[k] ? an : at[k];
    }
    h[R - 1] = below[R - 1] ? n : h[R - 1];
    at[R - 1] = below[R - 1] ? an : at[R - 1];
    return Key::value(m);
  };
  if (method == CWMED) {
    for (int i = 0; i < (K - 1) / 2; ++i) next();
    const float lo = next();
    if (K & 1) return lo;
    return __fmul_rn(0.5f, __fadd_rn(lo, next()));
  }
  for (int i = 0; i < trim; ++i) next();
  float sum = next();
  for (int i = trim + 1; i < K - trim; ++i) sum = __fadd_rn(sum, next());
  return __fmul_rn(sum, inv_keep);
}

}  // namespace repro
