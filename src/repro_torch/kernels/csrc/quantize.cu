// Per-tile symmetric int8 quantize / dequantize: the chain's update codec.
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/quantize.py:
//   quantize_kernel       (:34, pallas_call :39)  -- the K = 1 case below
//   quantize_stack_kernel (:66, pallas_call :74)  -- repro_quantize_rows
//   dequantize_kernel     (:92, pallas_call :97)  -- repro_dequantize
//
// Bound on an H100 (3.35 TB/s): bytes.  Quantizing the main path's (8,
// 430080) stack reads 13.8 MB of f32 and writes 3.4 MB of int8 plus 6.7 kB
// of scales, about 5.1 us; dequantizing one (430080,) blob moves 2.2 MB,
// about 0.6 us.  Each does a handful of operations per byte, far below the
// card's compute rate.  The design reads each input once and writes each
// output once: a block holds one (row, tile) in registers (8 lanes a
// thread, two 16-byte loads), reduces amax with warp shuffles and 9 floats
// of shared memory, and stores the eight int8 lanes as one 8-byte word, so
// neighbouring threads touch neighbouring addresses.  Nothing is staged
// through device memory between the max and the quantize.
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int nblk) {
  __shared__ float red[WARPS + 1];
  const int tile = blockIdx.x, row = blockIdx.y;
  const size_t base = (static_cast<size_t>(row) * nblk + tile) * BLOCK_D +
                      static_cast<size_t>(threadIdx.x) * PER_THREAD;
  const float4 a = *reinterpret_cast<const float4*>(x + base);
  const float4 b = *reinterpret_cast<const float4*>(x + base + 4);
  const float v[PER_THREAD] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) m = fmaxf(m, fabsf(v[i]));
  const float scale = tile_scale(block_max(m, red));
  int8_t out[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) out[i] = quantize_one(v[i], scale);
  *reinterpret_cast<uint2*>(q + base) = pack8(out);
  if (threadIdx.x == 0) s[static_cast<size_t>(row) * nblk + tile] = scale;
}

// out[i] = q[i] * s[i / BLOCK_D] over a contiguous (rows * nblk * BLOCK_D)
// range: one row, or a whole (K, Dpad) stack with (K, nblk) scales.
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(q[i]) * s[i / BLOCK_D];
}

}  // namespace repro

// x: (K, nblk * 2048) f32 -> q: same shape int8, s: (K, nblk) f32.
extern "C" int repro_quantize_rows(const void* x, void* q, void* s, int K,
                                   int nblk, void* stream) {
  if (K <= 0 || nblk <= 0 || K > 65535) return cudaErrorInvalidValue;
  repro::quantize_rows_kernel<<<dim3(nblk, K), repro::THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), nblk);
  return static_cast<int>(cudaGetLastError());
}

// q: (n,) int8 with n a multiple of 2048, s: (n / 2048,) f32 -> out: (n,) f32.
extern "C" int repro_dequantize(const void* q, const void* s, void* out,
                                long long n, void* stream) {
  if (n <= 0 || n % repro::BLOCK_D != 0) return cudaErrorInvalidValue;
  const long long blocks = n / repro::THREADS;
  repro::dequantize_kernel<<<static_cast<unsigned>(blocks), repro::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}
