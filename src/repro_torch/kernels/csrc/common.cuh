// Shared pieces of the port's int8 codec kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, never with --use_fast_math: the codec must
// round exactly as the reference's compiled kernels do, or the int8 blobs
// on the chain differ.  Those kernels divide x / scale in IEEE f32 and
// round half to even, but XLA rewrites a division by a constant into a
// multiply by the constant's f32 reciprocal, so the scale is
// amax * (1/127) and a mean of n values is sum * (1/n).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Lanes per quantization tile; one f32 scale per tile
// (repro_torch/kernels/tiling.py holds the same constant).
constexpr int BLOCK_D = 2048;
// One block per tile: 256 threads x 8 consecutive lanes each.
constexpr int THREADS = 256;
constexpr int PER_THREAD = BLOCK_D / THREADS;
constexpr int WARPS = THREADS / 32;

// Max over the block of a non-negative value; every thread gets the result.
// `red` holds WARPS + 1 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

// The reference's per-tile symmetric scale: amax * f32(1/127), or 1 for a
// tile that is all zero.
__device__ __forceinline__ float tile_scale(float amax) {
  return amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
}

// clip(round_half_even(x / scale), -127, 127) as int8.
__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  const float r = rintf(x / scale);
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// Eight int8 packed little-endian into two 32-bit words (one 8-byte store).
__device__ __forceinline__ uint2 pack8(const int8_t* v) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= static_cast<uint32_t>(static_cast<uint8_t>(v[i])) << (8 * i);
    hi |= static_cast<uint32_t>(static_cast<uint8_t>(v[i + 4])) << (8 * i);
  }
  return make_uint2(lo, hi);
}

__device__ __forceinline__ int8_t unpack8(uint2 w, int i) {
  const uint32_t word = i < 4 ? w.x : w.y;
  return static_cast<int8_t>((word >> (8 * (i & 3))) & 0xffu);
}

}  // namespace repro

// Message for a code returned by one of the C entry points.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
