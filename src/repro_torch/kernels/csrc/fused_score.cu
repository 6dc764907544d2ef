// Fused candidate rebuild for committee scoring: base + dequant(q_k) for
// every int8 update row k, in one pass, so the f32 update stack never exists.
//
// Replaces the reference's Pallas TPU kernel fused_candidates_kernel /
// _fused_candidates in src/repro/kernels/fused_score.py (:32-35,
// pallas_call :55).
//
// Bound on an H100 (3.35 TB/s): bytes.  The committee_int8 path rebuilds
// P = 54 candidates of Dpad = 430080 lanes: it reads 23.2 MB of int8, the
// 1.7 MB base and 45 kB of scales, and writes 92.9 MB of f32, 117.9 MB in
// all, about 35 us; two flops per lane are nothing beside that.  The
// output is larger than the 50 MB L2, so the f32 write is what bounds it.
// The design: one block per (tile, row), 256 threads x 8 consecutive lanes,
// one 8-byte int8 load and two 16-byte base loads per thread, two 16-byte
// f32 stores.  With P x 210 blocks the card is full; the base tile is
// re-read by all P rows of a tile, but 1.7 MB stays in L2, so device memory
// sees it about once.  Keeping one block per tile with a loop over rows
// would save those L2 reads but leave only 210 blocks for 132 SMs.
//
// Numerics: each lane is __fmaf_rn(float(q), s, base), one rounding, which
// is what XLA compiles the reference's base + q * s to (multiply-then-add,
// two roundings, differs from it on many lanes).
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(THREADS)
fused_candidates_kernel(const float* __restrict__ base,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out,
                        int nblk) {
  const int tile = blockIdx.x, row = blockIdx.y;
  const size_t lane0 = static_cast<size_t>(tile) * BLOCK_D +
                       static_cast<size_t>(threadIdx.x) * PER_THREAD;
  const size_t at = static_cast<size_t>(row) * nblk * BLOCK_D + lane0;
  const float sk = s[static_cast<size_t>(row) * nblk + tile];
  const uint2 raw = *reinterpret_cast<const uint2*>(q + at);
  const float4 b0 = *reinterpret_cast<const float4*>(base + lane0);
  const float4 b1 = *reinterpret_cast<const float4*>(base + lane0 + 4);
  const float b[PER_THREAD] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  float o[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    o[j] = __fmaf_rn(static_cast<float>(unpack8(raw, j)), sk, b[j]);
  *reinterpret_cast<float4*>(out + at) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(out + at + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

}  // namespace repro

// base: (nblk * 2048,) f32, q: (K, nblk * 2048) int8, s: (K, nblk) f32
// -> out: (K, nblk * 2048) f32.
extern "C" int repro_fused_candidates(const void* base, const void* q,
                                      const void* s, void* out, int K,
                                      int nblk, void* stream) {
  if (K <= 0 || K > 65535 || nblk <= 0) return cudaErrorInvalidValue;
  repro::fused_candidates_kernel<<<dim3(nblk, K), repro::THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(out), nblk);
  return static_cast<int>(cudaGetLastError());
}
