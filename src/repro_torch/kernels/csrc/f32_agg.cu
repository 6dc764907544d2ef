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
// loaded value, and a K = 8 sort 19 compare-exchanges a lane, far under the
// byte time.  Every kernel here runs one thread per lane, so a warp reads
// 128 contiguous bytes of a row at a time and the ragged edge is one bounds
// check (no padded copy of the stack).  fedavg keeps its sum in a register
// and its K loads independent of it.
//
// Sorting.  The reference sorts whole rows with an odd-even transposition
// network because a TPU lane has no control flow.  Here, for K <= 32, each
// thread loads its lane's K values into a register array of compile-time
// width W (8, 16 or 32, the smallest that holds K; the caller picks it),
// fills slots K..W-1 with +inf, which sort last, and sorts the W slots with
// Batcher's odd-even merge network (19, 63 or 191 compare-exchanges) of
// fminf / fmaxf at compile-time indices.  The network has no branches, so
// the lanes of a warp never diverge, and it touches no shared memory; the
// K loads are all issued before the first compare.  The median and the
// trimmed mean read the sorted slots through predicated, fully unrolled
// loops, so no slot is indexed at run time and the array stays in
// registers (ptxas -v: 0 bytes stack, 0 spills for each W; registers per
// thread in PERF.md).  This replaced a per-lane insertion sort in shared
// memory, whose data-dependent shifts made each warp wait for its slowest
// lane: 10.1-10.6 us at (8, 428350) against fedavg's 3.3 us for the same
// loads.  That sort stays as the path for K > 32 (sort_agg_kernel): each
// thread keeps its lane's column in shared memory, laid out column k at
// v[k * L + t] so the L threads of a block hit distinct banks, and the
// block's lane count L shrinks (256, 128, ... 1) until its K-deep columns
// fit the card's opt-in shared memory, queried once per device; only a K
// too deep for one lane is refused.
//
// Numerics follow the reference as compiled: fedavg is the chain
// acc = __fmaf_rn(x_k, w_k, acc) in k order from acc = 0; the median of an
// even count is 0.5 * (a + b); the trimmed mean is a sequential sum of the
// kept sorted values times f32(1 / kept).  Update stacks can hold -0.0 (a
// sign-flip attack negates exact zeros); a sort may put either zero of a
// tie first, so the median is held by value.  The trimmed mean starts its
// sum at -0.0, which adds exactly to anything, so it equals the reference's
// sum that starts at the first kept value.  Inputs are NaN-free, as on
// every path of the round: fminf drops a NaN, the insertion sort leaves it
// where it was, and torch.sort puts it last.
#include <atomic>
#include <utility>

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

// Batcher's odd-even merge sort of W slots (W a power of two, at most 32)
// as n compare-exchange pairs (lo[c], hi[c]), built by the compiler.
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

// K <= W rows: the lane's column in registers, sorted by the network.
template <int W>
__global__ void __launch_bounds__(THREADS)
sort_net_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                long long D, int method, int trim) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= D) return;
  float v[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    v[k] = k < K ? x[static_cast<size_t>(k) * D + i] : __int_as_float(0x7f800000);
  sort_slots(v, std::make_integer_sequence<int, SortNetwork<W>::net.n>{});
  if (method == CWMED) {
    const int m = K / 2;
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k == m - 1) lo = v[k];
      if (k == m) hi = v[k];
    }
    out[i] = (K & 1) ? hi : __fmul_rn(0.5f, __fadd_rn(lo, hi));
    return;
  }
  float sum = -0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k >= trim && k < K - trim) sum = __fadd_rn(sum, v[k]);
  out[i] = __fmul_rn(sum, __fdiv_rn(1.0f, static_cast<float>(K - 2 * trim)));
}

// Any K: the lane's column in shared memory, insertion-sorted.
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

// Per device: the opt-in shared memory a block may have (0 = not queried
// yet) and the dynamic size sort_agg_kernel is already allowed.
constexpr int MAX_DEVICES = 64;
std::atomic<int> smem_optin[MAX_DEVICES];
std::atomic<int> smem_allowed[MAX_DEVICES];

int launch_shared_sort(const float* x, float* out, int K, long long D,
                       int method, int trim, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int smem_max = smem_optin[dev].load(std::memory_order_relaxed);
  if (smem_max == 0) {
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_optin[dev].store(smem_max, std::memory_order_relaxed);
  }
  const long long column = 4LL * K;
  int L = THREADS;
  while (L > 1 && column * L > smem_max) L >>= 1;
  if (column * L > smem_max) return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(column * L);
  if (bytes > 48 * 1024 &&
      bytes > smem_allowed[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(sort_agg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev].store(bytes, std::memory_order_relaxed);
  }
  const long long blocks = (D + L - 1) / L;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sort_agg_kernel<<<static_cast<unsigned>(blocks), L, bytes, stream>>>(
      x, out, K, D, method, trim);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_network_sort(const float* x, float* out, int K, long long D,
                        int method, int trim, cudaStream_t stream) {
  const long long blocks = (D + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sort_net_kernel<W><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      x, out, K, D, method, trim);
  return static_cast<int>(cudaGetLastError());
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
// the sorted values [trim, K - trim).  width 8, 16 or 32 sorts in registers
// (K <= width); width 0 sorts in shared memory (any K that fits one lane).
extern "C" int repro_sort_agg(const void* x, void* out, int K, long long D,
                              int method, int trim, int width, void* stream) {
  if (K <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (method != repro::CWMED && method != repro::TRIMMED_MEAN)
    return cudaErrorInvalidValue;
  if (method == repro::TRIMMED_MEAN && (trim < 0 || 2 * trim >= K))
    return cudaErrorInvalidValue;
  if (width != 0 && K > width) return cudaErrorInvalidValue;
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 0: return repro::launch_shared_sort(xs, o, K, D, method, trim, s);
    case 8: return repro::launch_network_sort<8>(xs, o, K, D, method, trim, s);
    case 16: return repro::launch_network_sort<16>(xs, o, K, D, method, trim, s);
    case 32: return repro::launch_network_sort<32>(xs, o, K, D, method, trim, s);
    default: return cudaErrorInvalidValue;
  }
}
