// f32 aggregation of K update rows per lane: weighted sum (fedavg), median
// (cwmed) and trimmed mean, over a (K, D) f32 stack of any K and any D.
//
// Replaces the reference's Pallas TPU kernels
//   fedavg_agg_kernel   src/repro/kernels/fedavg_agg.py (_fedavg_kernel
//                       :23-27, pallas_call :39)       -- repro_fedavg_agg
//   cwmed_kernel        src/repro/kernels/cwmed.py (_cwmed_kernel :57-59,
//                       sort_rows :27, pallas_call :67) -- repro_sort_agg
//   trimmed_mean_kernel src/repro/kernels/cwmed.py (_trimmed_mean_kernel
//                       :78-80, pallas_call :91)        -- repro_sort_agg
//
// Bound on an H100 (3.35 TB/s): bytes.  The f32 path's (8, 428350) stack is
// 13.7 MB read and 1.7 MB written, about 4.6 us; fedavg does two flops a
// loaded value, and the sort does about K * (K - 1) / 2 compares a lane,
// which at K = 8 is still far under the byte time.  The design: one thread
// per lane, so a warp reads 128 contiguous bytes of a row at a time and
// the ragged edge is one bounds check (no padded copy of the stack).
// fedavg keeps its sum in a register and its K loads independent of it.
// The reference sorts whole rows with an odd-even network because a TPU
// lane has no control flow; here each thread insertion-sorts its own
// lane's K values in shared memory, laid out column k at v[k * L + t] so
// the L threads of a block hit distinct banks.  There is no cap on K: the
// block's lane count L shrinks (256, 128, ... 1) until its K-deep columns
// fit the card's shared memory, and only a K too deep for one lane is
// refused.
//
// Numerics follow the reference as compiled: fedavg is the chain
// acc = __fmaf_rn(x_k, w_k, acc) in k order from acc = 0; the median of an
// even count is 0.5 * (a + b); the trimmed mean is a sequential sum of the
// kept sorted values times f32(1 / kept).  Update stacks can hold -0.0 (a
// sign-flip attack negates exact zeros); the sort orders +0.0 and -0.0 as
// equal, as any comparison sort does, so a median may return either zero.
#include "common.cuh"

namespace repro {

constexpr int CWMED = 1, TRIMMED_MEAN = 2;

__global__ void __launch_bounds__(THREADS)
fedavg_agg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int K, long long D) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= D) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k)
    acc = __fmaf_rn(x[static_cast<size_t>(k) * D + i], w[k], acc);
  out[i] = acc;
}

__global__ void __launch_bounds__(THREADS)
sort_agg_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                long long D, int method, int trim) {
  extern __shared__ float v[];
  const int L = blockDim.x;
  const long long i = static_cast<long long>(blockIdx.x) * L + threadIdx.x;
  if (i >= D) return;  // no barrier below: each thread owns its column
  float* col = v + threadIdx.x;
  for (int k = 0; k < K; ++k) col[k * L] = x[static_cast<size_t>(k) * D + i];
  for (int a = 1; a < K; ++a) {
    const float key = col[a * L];
    int b = a - 1;
    while (b >= 0 && col[b * L] > key) {
      col[(b + 1) * L] = col[b * L];
      --b;
    }
    col[(b + 1) * L] = key;
  }
  if (method == CWMED) {
    out[i] = (K & 1) ? col[(K / 2) * L]
                     : __fmul_rn(0.5f, __fadd_rn(col[(K / 2 - 1) * L],
                                                 col[(K / 2) * L]));
    return;
  }
  float sum = col[trim * L];
  for (int k = trim + 1; k < K - trim; ++k) sum = __fadd_rn(sum, col[k * L]);
  out[i] = __fmul_rn(sum, __fdiv_rn(1.0f, static_cast<float>(K - 2 * trim)));
}

}  // namespace repro

// x: (K, D) f32, w: (K,) f32 taken as given -> out: (D,) f32.
extern "C" int repro_fedavg_agg(const void* x, const void* w, void* out, int K,
                                long long D, void* stream) {
  if (K <= 0 || D <= 0) return cudaErrorInvalidValue;
  const long long blocks = (D + repro::THREADS - 1) / repro::THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::fedavg_agg_kernel<<<static_cast<unsigned>(blocks), repro::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), K, D);
  return static_cast<int>(cudaGetLastError());
}

// x: (K, D) f32 -> out: (D,) f32; method 1 = median, 2 = trimmed mean of
// the sorted values [trim, K - trim).
extern "C" int repro_sort_agg(const void* x, void* out, int K, long long D,
                              int method, int trim, void* stream) {
  if (K <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (method != repro::CWMED && method != repro::TRIMMED_MEAN)
    return cudaErrorInvalidValue;
  if (method == repro::TRIMMED_MEAN && (trim < 0 || 2 * trim >= K))
    return cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long column = 4LL * K;
  int L = repro::THREADS;
  while (L > 1 && column * L > smem_max) L >>= 1;
  if (column * L > smem_max) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(column * L);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(repro::sort_agg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (D + L - 1) / L;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::sort_agg_kernel<<<static_cast<unsigned>(blocks), L, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), K, D, method,
      trim);
  return static_cast<int>(cudaGetLastError());
}
