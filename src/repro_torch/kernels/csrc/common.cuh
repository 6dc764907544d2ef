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

#include <atomic>

namespace repro {

// Lanes per quantization tile; one f32 scale per tile
// (repro_torch/kernels/tiling.py holds the same constant).
constexpr int BLOCK_D = 2048;
// 256 threads x 8 consecutive lanes: one block per tile (fused_score.cu).
constexpr int THREADS = 256;
constexpr int PER_THREAD = BLOCK_D / THREADS;

// Max over a warp; every lane gets the result.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max over a block of NWARPS full warps; every thread gets the result.
// `red` holds NWARPS floats of shared memory.
template <int NWARPS>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) v = fmaxf(v, red[i]);
  return v;
}

// The reference's per-tile symmetric scale: amax * f32(1/127), or 1 for a
// tile that is all zero.
__device__ __forceinline__ float tile_scale(float amax) {
  return amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
}

// clip(round_half_even(x / scale), -127, 127) in the low byte of the
// result, as int8.  The quotient is clipped first (the same thing, since
// clipping to integers commutes with rounding), then 1.5 * 2^23 is added:
// the sum's unit in the last place is 1, so the addition rounds half to
// even at integer steps and leaves the integer in the low mantissa bits.
// One addition takes the place of rintf and a float-to-int conversion, an
// instruction the H100 issues at a quarter of the rate.
__device__ __forceinline__ uint32_t quantize_bits(float x, float scale) {
  const float y = fminf(fmaxf(__fdiv_rn(x, scale), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(y, 12582912.0f));
}

// The same integer from x * inv, inv = RN(1 / scale), without the IEEE
// division (a reciprocal at a quarter of the rate, and a slow path for a
// zero or subnormal x, which padding and all-zero tiles are full of).  For
// scale in [2^-100, 2^100] the product y is within 3.01 ulps of |y| of the
// quotient x / scale, and the quotient's rounding RN(x / scale) within one
// more, so both round to the same integer unless y lies within
// |y| * 2^-22 of a half-integer.  That distance is exact where it matters
// (y minus its nearest integer is exact, and so is 0.5 minus that when it
// is at least 0.25); `redo` is set where it is too small, and the caller
// then divides.  Beyond +-127 both clip to +-127.
__device__ __forceinline__ uint32_t quantize_bits_by(float x, float inv,
                                                     bool& redo) {
  const float y = fminf(fmaxf(__fmul_rn(x, inv), -127.0f), 127.0f);
  const float t = __fadd_rn(y, 12582912.0f);
  const float from_half =
      __fsub_rn(0.5f, fabsf(__fsub_rn(y, __fsub_rn(t, 12582912.0f))));
  redo |= !(from_half > fabsf(y) * 0x1p-22f);
  return __float_as_uint(t);
}

// The per-tile quantizer: the scale, and RN(1 / scale) where the
// reciprocal path above is exact (0 where it is not: every value divides).
struct TileQuantizer {
  float scale, inv;
};

__device__ __forceinline__ TileQuantizer tile_quantizer(float amax) {
  const float scale = tile_scale(amax);
  return {scale, scale >= 0x1p-100f && scale <= 0x1p100f ? __frcp_rn(scale)
                                                          : 0.0f};
}

// Four consecutive lanes quantized and packed little-endian into one word.
__device__ __forceinline__ uint32_t quantize4(float a, float b, float c,
                                              float d, TileQuantizer tq) {
  bool redo = tq.inv == 0.0f;
  uint32_t ta = quantize_bits_by(a, tq.inv, redo);
  uint32_t tb = quantize_bits_by(b, tq.inv, redo);
  uint32_t tc = quantize_bits_by(c, tq.inv, redo);
  uint32_t td = quantize_bits_by(d, tq.inv, redo);
  if (redo) {
    ta = quantize_bits(a, tq.scale);
    tb = quantize_bits(b, tq.scale);
    tc = quantize_bits(c, tq.scale);
    td = quantize_bits(d, tq.scale);
  }
  return __byte_perm(__byte_perm(ta, tb, 0x0040), __byte_perm(tc, td, 0x0040),
                     0x5410);
}

// The high half of 2^23's bits, as bytes (0x00, 0x4b), for lane_value.
// Kernels take it as an argument: with it and the byte selector both
// literals, the compiler moves one of the two into a register before every
// byte permute.  (A __constant__ variable instead added about 0.1 us to
// every launch of every kernel in its library on the H100; PERF.md.)
constexpr uint32_t F32_EXPONENT_BYTES = 0x4b00u;

// Byte l of a word of four int8 lanes, as an exact f32, given the word
// xor 0x80808080 (each byte b stored as b + 128) and F32_EXPONENT_BYTES.
// b + 128 is placed in the low mantissa bits of 2^23 and 2^23 + 128
// subtracted: a byte permute and an exact subtraction, in place of a
// conversion instruction.
__device__ __forceinline__ float lane_value(uint32_t biased, int l,
                                            uint32_t exponent_bytes) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(biased, exponent_bytes, 0x5440u | l)),
      8388736.0f);
}
constexpr uint32_t BYTE_BIAS = 0x80808080u;

__device__ __forceinline__ int8_t unpack8(uint2 w, int i) {
  const uint32_t word = i < 4 ? w.x : w.y;
  return static_cast<int8_t>((word >> (8 * (i & 3))) & 0xffu);
}

// Dynamic shared memory for kernels whose per-lane columns live there.
// Per device: the opt-in size a block may have (queried once) and, per
// kernel, the largest size already granted.
constexpr int MAX_DEVICES = 64;
inline std::atomic<int> smem_optin_bytes[MAX_DEVICES];

// The current device and its opt-in shared memory per block.
inline int device_smem(int* dev, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *optin = smem_optin_bytes[*dev].load(std::memory_order_relaxed);
  if (*optin == 0) {
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_optin_bytes[*dev].store(*optin, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Lets `kernel` take `bytes` of dynamic shared memory on device `dev`;
// `granted` is that kernel's per-device record.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int dev, int bytes,
                      std::atomic<int>* granted) {
  if (bytes <= 48 * 1024 ||
      bytes <= granted[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  granted[dev].store(bytes, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace repro

// Message for a code returned by one of the C entry points.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
