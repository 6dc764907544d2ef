// Fused int8 aggregation: dequantize in registers, reduce over the K update
// rows per lane (weighted sum, median or trimmed mean), and optionally
// requantize each output tile in the same pass.
//
// Replaces the reference's Pallas TPU kernel fused_agg_kernel /
// make_fused_agg_fn in src/repro/kernels/fused_agg.py (:140 / :72,
// pallas_call :111 and :120), with the odd-even sort it borrows from
// src/repro/kernels/cwmed.py (:27-54).
//
// Bound on an H100 (3.35 TB/s): bytes.  The main path's fedavg over an (8,
// 430080) int8 stack reads 3.4 MB of int8 plus 13 kB of scales and writes
// 1.7 MB of f32: about 1.5 us.  fedavg does four flops per input byte; the
// sort methods do O(K^2) compares per lane, which at K = 8 is still under
// the byte time.  The design keeps the stack's only read an int8 read: one
// block per 2048-lane tile, each thread owns 8 consecutive lanes, loads
// each row's 8 lanes as one 8-byte word, and keeps every dequantized value
// in registers (a per-lane array for the sorts), so the f32 (K, D) stack
// never exists in device memory.  With quantize_out the block's amax comes
// from warp shuffles and shared memory and the int8 tile is written
// directly.
//
// Numerics follow the reference as compiled: fedavg dequantizes with one
// rounding (__fmul_rn) and accumulates one row at a time with a fused
// multiply-add, acc = fma(q * s, w, acc), which is what XLA emits for the
// reference's sum(rows * w); the median of an even count is
// 0.5 * (a + b); the trimmed mean is a sequential sum of the kept sorted
// rows times the f32 reciprocal of their count (see common.cuh).
#include "common.cuh"

namespace repro {

constexpr int FEDAVG = 0, CWMED = 1, TRIMMED_MEAN = 2;
// Largest K the sort methods take: the per-lane array lives in registers /
// local memory.
constexpr int MAX_SORT_K = 64;

__global__ void __launch_bounds__(THREADS)
fused_agg_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 const float* __restrict__ w, float* __restrict__ out,
                 int8_t* __restrict__ qout, float* __restrict__ sout, int K,
                 int nblk, int method, int trim) {
  __shared__ float red[WARPS + 1];
  const int tile = blockIdx.x;
  const size_t dpad = static_cast<size_t>(nblk) * BLOCK_D;
  const size_t lane0 = static_cast<size_t>(tile) * BLOCK_D +
                       static_cast<size_t>(threadIdx.x) * PER_THREAD;
  float acc[PER_THREAD];

  if (method == FEDAVG) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float sk = s[static_cast<size_t>(k) * nblk + tile];
      const float wk = w[k];
      const uint2 raw =
          *reinterpret_cast<const uint2*>(q + static_cast<size_t>(k) * dpad + lane0);
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const float deq = __fmul_rn(static_cast<float>(unpack8(raw, j)), sk);
        acc[j] = __fmaf_rn(deq, wk, acc[j]);
      }
    }
  } else {
    const float inv_keep = __fdiv_rn(1.0f, static_cast<float>(K - 2 * trim));
    float v[MAX_SORT_K];
    for (int j = 0; j < PER_THREAD; ++j) {
      for (int k = 0; k < K; ++k)
        v[k] = __fmul_rn(
            static_cast<float>(q[static_cast<size_t>(k) * dpad + lane0 + j]),
            s[static_cast<size_t>(k) * nblk + tile]);
      // insertion sort, ascending (values are finite and never -0.0, so
      // any correct sort gives the reference network's order statistics)
      for (int a = 1; a < K; ++a) {
        const float key = v[a];
        int b = a - 1;
        while (b >= 0 && v[b] > key) {
          v[b + 1] = v[b];
          --b;
        }
        v[b + 1] = key;
      }
      if (method == CWMED) {
        acc[j] = (K & 1) ? v[K / 2]
                         : __fmul_rn(0.5f, __fadd_rn(v[K / 2 - 1], v[K / 2]));
      } else {
        float sum = v[trim];
        for (int k = trim + 1; k < K - trim; ++k) sum = __fadd_rn(sum, v[k]);
        acc[j] = __fmul_rn(sum, inv_keep);
      }
    }
  }

  if (qout == nullptr) {
    *reinterpret_cast<float4*>(out + lane0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + lane0 + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
    return;
  }
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) m = fmaxf(m, fabsf(acc[j]));
  const float scale = tile_scale(block_max(m, red));
  int8_t qv[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) qv[j] = quantize_one(acc[j], scale);
  *reinterpret_cast<uint2*>(qout + lane0) = pack8(qv);
  if (threadIdx.x == 0) sout[tile] = scale;
}

}  // namespace repro

// q: (K, nblk * 2048) int8, s: (K, nblk) f32, w: (K,) f32 normalized.
// quantize_out == 0: out (nblk * 2048,) f32 (qout, sout unused).
// quantize_out != 0: qout (nblk * 2048,) int8 and sout (nblk,) f32.
extern "C" int repro_fused_agg(const void* q, const void* s, const void* w,
                               void* out, void* qout, void* sout, int K,
                               int nblk, int method, int trim,
                               int quantize_out, void* stream) {
  if (K <= 0 || nblk <= 0 || method < repro::FEDAVG ||
      method > repro::TRIMMED_MEAN)
    return cudaErrorInvalidValue;
  if (method != repro::FEDAVG && K > repro::MAX_SORT_K)
    return cudaErrorInvalidValue;
  if (method == repro::TRIMMED_MEAN && (trim < 0 || 2 * trim >= K))
    return cudaErrorInvalidValue;
  repro::fused_agg_kernel<<<nblk, repro::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(out),
      quantize_out ? static_cast<int8_t*>(qout) : nullptr,
      static_cast<float*>(sout), K, nblk, method, trim);
  return static_cast<int>(cudaGetLastError());
}
