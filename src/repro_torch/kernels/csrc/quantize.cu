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
//
// Dequantize runs on every update block read off the chain, one blob a
// call.  A launch that moves 2.2 MB is short enough that launch and
// ramp-up take most of its time (the same kernel on one tile takes about
// two thirds of the main blob's time; PERF.md), so the kernel issues few,
// wide and fully coalesced memory operations.
// Each thread takes 4 consecutive lanes (one 4-byte int8 load and one
// 16-byte f32 store), so every load and store of a warp covers 128 or 512
// contiguous bytes; a block covers 1024 lanes inside one tile and reads
// the tile's scale once, at the address all its threads share.  This
// replaced one lane a thread (a 1-byte load and a 4-byte store), 2.0 us
// for the main blob.  Wider threads measured slower on the H100 (PERF.md):
// 8 or 16 consecutive lanes, because a warp's 16-byte stores then land 32
// or 64 bytes apart and each line is written by two or four instructions,
// and 8 lanes as two such 4-lane chunks, one block a tile.
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

// out[i] = q[i] * s[i / BLOCK_D] over a contiguous run of whole tiles: one
// row, or a whole (K, Dpad) stack with (K, nblk) scales.
constexpr int DEQ_SPAN = THREADS * 4;  // lanes of one block
static_assert(BLOCK_D % DEQ_SPAN == 0, "a block inside one tile");

__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out) {
  const size_t first = static_cast<size_t>(blockIdx.x) * DEQ_SPAN +
                       4 * threadIdx.x;
  const float scale = s[static_cast<size_t>(blockIdx.x) * DEQ_SPAN / BLOCK_D];
  const uint32_t w = *reinterpret_cast<const uint32_t*>(q + first);
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu)) * scale;
  *reinterpret_cast<float4*>(out + first) = make_float4(f[0], f[1], f[2], f[3]);
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

// q: (n,) int8 with n a multiple of 2048, s: (n / 2048,) f32 -> out: (n,)
// f32.  q must be 4-byte and out 16-byte aligned.
extern "C" int repro_dequantize(const void* q, const void* s, void* out,
                                long long n, void* stream) {
  if (n <= 0 || n % repro::BLOCK_D != 0) return cudaErrorInvalidValue;
  const long long blocks = n / repro::DEQ_SPAN;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::dequantize_kernel<<<static_cast<unsigned>(blocks), repro::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
