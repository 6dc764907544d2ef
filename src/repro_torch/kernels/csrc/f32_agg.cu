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
// width W (8, 16 or 32, the smallest that holds K; the C entry picks it),
// fills slots K..W-1 with +inf and sorts them with sort_net.cuh's Batcher
// network; the K loads are all issued before the first compare, and the
// median and trimmed mean are read without a run-time index, so the array
// stays in registers (0 bytes stack, 0 spills for each W; registers per
// thread in PERF.md).  This replaced a per-lane insertion sort in shared
// memory, whose data-dependent shifts made each warp wait for its slowest
// lane: 10.1-10.6 us at (8, 428350) against fedavg's 3.3 us for the same
// loads.
//
// For 33 <= K <= 128 (sort_merge_kernel<R>) a thread still owns one lane:
// it asks for its whole column at once (cp.async into its column of shared
// memory, so K loads are in flight, not 32), sorts it as R = ceil(K / 32)
// runs of 32 in registers (the last by the narrowest network that holds
// it), stores each back as order keys, and merges the runs by their heads up to
// the median's rank or through the trimmed mean's kept ranks
// (sort_net.cuh merge_reduce): about K log K branch-free steps a lane.  A
// lane's column is R * 33 keys, so a block of 128 lanes takes 34-68 KB and
// an SM holds 12-24 warps.  The insertion sort stays for K > 128
// (sort_agg_kernel): each thread keeps its lane's column in shared memory,
// laid out column k at v[k * L + t] so the L threads of a block hit
// distinct banks, and the block's lane count L shrinks (256, 128, ... 1)
// until its K-deep columns fit the card's opt-in shared memory; only a K
// too deep for one lane is refused.  The C entry's `insertion` flag takes
// the insertion sort at any K instead, to time it beside the run merge
// (chip_smoke.py).
//
// Numerics follow the reference as compiled: fedavg is the chain
// acc = __fmaf_rn(x_k, w_k, acc) in k order from acc = 0; the median of an
// even count is 0.5 * (a + b); the trimmed mean is a sequential sum of the
// kept sorted values times f32(1 / kept) (sort_net.cuh).  Update stacks can
// hold -0.0 (a sign-flip attack negates exact zeros); a sort may put either
// zero of a tie first, so the median is held by value; the run merge
// compares order keys that put -0.0 below +0.0, as fminf / fmaxf do, so its
// runs merge into one sequence sorted as each run is.  Inputs are NaN-free,
// as on every path of the round: fminf drops a NaN, the insertion sort
// leaves it where it was, and torch.sort puts it last.
#include "common.cuh"
#include "sort_net.cuh"

namespace repro {

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

// K <= W rows: the lane's column in registers, sorted by the network.
template <int W>
__global__ void __launch_bounds__(THREADS)
sort_net_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                long long D, int method, int trim, float inv_keep) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= D) return;
  float v[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    v[k] = k < K ? x[static_cast<size_t>(k) * D + i] : __int_as_float(0x7f800000);
  sort_slots(v);
  out[i] = method == CWMED ? median_of_slots(v, K)
                          : trimmed_mean_of_slots(v, K, trim, inv_keep);
}

// 32 (R - 1) < K <= 32 R: the lane's column as R sorted runs of 32 in shared
// memory, merged (sort_net.cuh).
template <int R>
__global__ void __launch_bounds__(MERGE_THREADS)
sort_merge_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                  long long D, int method, int trim, float inv_keep) {
  extern __shared__ int keys[];
  const long long i =
      static_cast<long long>(blockIdx.x) * MERGE_THREADS + threadIdx.x;
  if (i >= D) return;  // no barrier below: each thread owns its column
  int* col = keys + threadIdx.x;
  // the column's K values into its run slots (run r's row k at slot
  // r * RUN_SLOTS + k), all asked for at once, a commit group a run
  const float* row = x + i;
  for (int r = 0; r < R; ++r) {
    for (int k = r * RUN; k < min(K, (r + 1) * RUN); ++k, row += D)
      async_copy4(col + (k + r) * MERGE_THREADS, row);
    async_copies_commit();
  }
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int n = min(K - r * RUN, RUN);
    int* run = col + r * RUN_SLOTS * MERGE_THREADS;
    async_copies_wait(R - 1 - r);
    float v[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      v[k] = k < n ? __int_as_float(run[k * MERGE_THREADS])
                   : __int_as_float(0x7f800000);
    sort_run(v, n);
    store_run<OrderedKey, MERGE_THREADS>(run, v);
  }
  out[i] = merge_reduce<R, OrderedKey, MERGE_THREADS>(col, K, method, trim,
                                                      inv_keep);
}

// Any K: the lane's column in shared memory, insertion-sorted.
__global__ void __launch_bounds__(THREADS)
sort_agg_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                long long D, int method, int trim, float inv_keep) {
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
  out[i] = __fmul_rn(sum, inv_keep);
}

std::atomic<int> sort_smem_granted[MAX_DEVICES];

int launch_shared_sort(const float* x, float* out, int K, long long D,
                       int method, int trim, float inv_keep,
                       cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  int err = device_smem(&dev, &smem_max);
  if (err != cudaSuccess) return err;
  const long long column = 4LL * K;
  int L = THREADS;
  while (L > 1 && column * L > smem_max) L >>= 1;
  if (column * L > smem_max) return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(column * L);
  err = allow_smem(sort_agg_kernel, dev, bytes, sort_smem_granted);
  if (err != cudaSuccess) return err;
  const long long blocks = (D + L - 1) / L;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sort_agg_kernel<<<static_cast<unsigned>(blocks), L, bytes, stream>>>(
      x, out, K, D, method, trim, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_merge_sort(const float* x, float* out, int K, long long D,
                      int method, int trim, float inv_keep,
                      cudaStream_t stream) {
  static std::atomic<int> granted[MAX_DEVICES];
  int dev = 0, optin = 0;
  int err = device_smem(&dev, &optin);
  if (err != cudaSuccess) return err;
  const int bytes = merge_smem_bytes(R, MERGE_THREADS);
  err = allow_smem(sort_merge_kernel<R>, dev, bytes, granted);
  if (err != cudaSuccess) return err;
  const long long blocks = (D + MERGE_THREADS - 1) / MERGE_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sort_merge_kernel<R><<<static_cast<unsigned>(blocks), MERGE_THREADS, bytes,
                         stream>>>(x, out, K, D, method, trim, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_network_sort(const float* x, float* out, int K, long long D,
                        int method, int trim, float inv_keep,
                        cudaStream_t stream) {
  const long long blocks = (D + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sort_net_kernel<W><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      x, out, K, D, method, trim, inv_keep);
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
// the sorted values [trim, K - trim).  The design (sort_net.cuh sort_path):
// K <= 32 sorts in registers, 33 <= K <= 128 by the run merge, K > 128 by
// the insertion sort in shared memory, for any K whose column fits one
// lane; insertion != 0 takes the insertion sort at any K.  With `path`
// non-null nothing is launched (x and out may be null) and the design is
// written there: {design, size} (sort_net.cuh).
extern "C" int repro_sort_agg(const void* x, void* out, int K, long long D,
                              int method, int trim, int insertion, int* path,
                              void* stream) {
  if (K <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (method != repro::CWMED && method != repro::TRIMMED_MEAN)
    return cudaErrorInvalidValue;
  if (method == repro::TRIMMED_MEAN && (trim < 0 || 2 * trim >= K))
    return cudaErrorInvalidValue;
  const repro::SortPath sp = repro::sort_path(K, insertion != 0);
  if (path) {
    path[0] = sp.design;
    path[1] = sp.size;
    return cudaSuccess;
  }
  if (method != repro::TRIMMED_MEAN) trim = 0;
  // f32(1 / kept), rounded as the device's __fdiv_rn rounds it
  const float ik = 1.0f / static_cast<float>(K - 2 * trim);
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sp.design == repro::NETWORK) {
    switch (sp.size) {
      case 8: return repro::launch_network_sort<8>(xs, o, K, D, method, trim, ik, s);
      case 16: return repro::launch_network_sort<16>(xs, o, K, D, method, trim, ik, s);
      default: return repro::launch_network_sort<32>(xs, o, K, D, method, trim, ik, s);
    }
  }
  if (sp.design == repro::RUN_MERGE) {
    switch (sp.size) {
      case 2: return repro::launch_merge_sort<2>(xs, o, K, D, method, trim, ik, s);
      case 3: return repro::launch_merge_sort<3>(xs, o, K, D, method, trim, ik, s);
      default: return repro::launch_merge_sort<4>(xs, o, K, D, method, trim, ik, s);
    }
  }
  return repro::launch_shared_sort(xs, o, K, D, method, trim, ik, s);
}
