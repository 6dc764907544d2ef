// Per-tile symmetric int8 quantize / dequantize: the chain's update codec.
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/quantize.py:
//   quantize_kernel       (:34, pallas_call :39)  -- repro_quantize_rows, K = 1
//   quantize_stack_kernel (:66, pallas_call :74)  -- repro_quantize_rows
//   dequantize_kernel     (:92, pallas_call :97)  -- repro_dequantize
//
// Bound on an H100 (3.35 TB/s): bytes.  Quantizing the main path's (8,
// 430080) stack reads 13.8 MB of f32 and writes 3.4 MB of int8 plus 6.7 kB
// of scales, about 5.1 us; one (430080,) vector moves 2.2 MB, about 0.6 us;
// dequantizing one (430080,) blob moves 2.2 MB, about 0.6 us.  Each does a
// handful of operations per byte, far below the card's compute rate.
//
// Quantize: one block of 4 warps per (row, tile).  Thread t takes the
// tile's lanes 4t + 512j for j < 4: four 16-byte loads, each covering 512
// contiguous bytes across a warp, all issued before the amax, which takes
// warp shuffles and one barrier over 4 floats of shared memory; then each
// thread writes its 4 int8 lanes of a step as one 4-byte word (128
// contiguous bytes a warp).  The bytes are rounded from x * (1 / scale)
// without a conversion instruction and fall back to the IEEE division only
// near a half-integer (common.cuh quantize4): the division's slow path,
// taken for every zero, made the tile holding a vector's zero padding the
// launch's straggler.  This replaced 256 threads of 8 consecutive lanes a
// tile (16-byte accesses 32 bytes apart across a warp, a two-barrier amax,
// a division per lane).  One warp a tile (16 loads a thread, no barrier)
// measured slower on the H100 (PERF.md): 210 warps for one vector leave
// each warp's 64 lanes of serial work on the critical path.
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

constexpr int QUANT_WARPS = 4;                       // warps a tile
constexpr int QUANT_SPAN = 32 * 4 * QUANT_WARPS;     // lanes a step
constexpr int QUANT_STEPS = BLOCK_D / QUANT_SPAN;    // float4 a thread

// x: whole tiles, contiguous -> q (same lanes) int8, s (one a tile).  One
// block per tile.
__global__ void __launch_bounds__(32 * QUANT_WARPS)
quantize_tiles_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s) {
  __shared__ float red[QUANT_WARPS];
  const size_t tile = blockIdx.x;
  const size_t first = tile * BLOCK_D + 4 * threadIdx.x;
  float4 v[QUANT_STEPS];
#pragma unroll
  for (int j = 0; j < QUANT_STEPS; ++j)
    v[j] = *reinterpret_cast<const float4*>(x + first + QUANT_SPAN * j);
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < QUANT_STEPS; ++j)
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                       fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
  const TileQuantizer tq = tile_quantizer(block_max<QUANT_WARPS>(m, red));
#pragma unroll
  for (int j = 0; j < QUANT_STEPS; ++j)
    *reinterpret_cast<uint32_t*>(q + first + QUANT_SPAN * j) =
        quantize4(v[j].x, v[j].y, v[j].z, v[j].w, tq);
  if (threadIdx.x == 0) s[tile] = tq.scale;
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
// x must be 16-byte and q 4-byte aligned.
extern "C" int repro_quantize_rows(const void* x, void* q, void* s, int K,
                                   int nblk, void* stream) {
  if (K <= 0 || nblk <= 0) return cudaErrorInvalidValue;
  const long long ntiles = static_cast<long long>(K) * nblk;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::quantize_tiles_kernel<<<static_cast<unsigned>(ntiles),
                                 32 * repro::QUANT_WARPS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s));
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

