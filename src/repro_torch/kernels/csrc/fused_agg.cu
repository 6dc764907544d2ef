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
// 1.7 MB of f32: about 1.5 us.  One launch of that size is one wave of
// short blocks, so what costs beyond the bytes is latency: the launch, the
// round trips to memory each thread waits on, and the instructions every
// thread issues after its loads arrive.  The design:
//   - Each thread owns 4 consecutive lanes: a row's int8 is one 4-byte load
//     (a warp reads 128 contiguous bytes of it) and the f32 result one
//     16-byte store (a warp writes 512 contiguous bytes).  Blocks of 128
//     threads, 4 to a tile; with quantize_out one block of 512 threads
//     covers the tile, whose amax it needs.
//   - fedavg loads rows in compile-time chunks of 8: every row's word, scale
//     and weight of a chunk is asked for before the first multiply-add, so
//     one round trip serves all K <= 8 rows of the main path.  Bringing
//     each row's block segment into shared memory by one thread's 1-D bulk
//     copies on an mbarrier measured slower on the H100 (PERF.md).
//   - A byte becomes an f32 by a byte permute and an exact subtraction
//     (common.cuh lane_value), not by a conversion instruction, which the
//     H100 issues at a quarter of the rate; quantize_out packs its bytes
//     the same way (quantize4).
//   - cwmed and trimmed_mean for K <= 32 load the thread's K words and
//     scales at once (rows past K reload row K - 1, so no load is
//     predicated), then for each of its 4 lanes fill W = 8, 16 or 32
//     register slots (rows past K become 1 * FLT_MAX, set once per row, not
//     per lane), sort them with sort_net.cuh's Batcher network and read the
//     median or trimmed mean without a run-time index: no stack, no spills.
//     The trimmed mean weighs the sorted slots by 1.0 or 0.0 from a kernel
//     argument, in the constant bank, so its reader is one fused
//     multiply-add a slot; f32(1 / kept) comes from the host.  A sort
//     issues several times fedavg's instructions for the same bytes, so on
//     the H100 it is bound by instruction issue more than by bytes, and an
//     instruction saved a lane shows in its time (PERF.md).
//   - For 33 <= K <= 128 (fused_lane_kernel<R>, R = ceil(K / 32)) the grid
//     covers the lanes, one lane a thread, blocks of 128.  A block first
//     asks for its K x 128 bytes and the tile's K scales at once (cp.async
//     into shared memory, a group a run of 32 rows): with one byte a lane a
//     row, a thread's own loads would put too few bytes in flight to cover
//     the memory's latency.
//     Each thread then sorts its lane's column as R runs of 32 in registers
//     as they arrive, stores them to its column of shared memory and
//     merges them by their heads to the median's rank or through the
//     trimmed mean's kept ranks (sort_net.cuh merge_reduce): about K log K
//     branch-free steps a lane, where the insertion sort it replaced
//     shifted about K^2 / 4 times.  A lane's column is R * 33 floats
//     (34-68 KB a block; the copied bytes sit in the last run's slots).
//     quantize_out needs a tile's amax over 16 such blocks: the lanes go to
//     f32 in `out` (scratch the wrapper gives), then requantize_kernel, a
//     block of 512 a tile, quantizes them exactly as the quantize_out form
//     above does (common.cuh's tile_quantizer and quantize4).
//   - For K > 128 (fused_column_kernel) one block per tile sorts each lane's
//     column in shared memory by insertion, L lanes at a time, L shrinking
//     (256, 128, ... 1) until the K-deep columns fit the card's opt-in
//     shared memory; only a K too deep for one lane is refused.  About
//     K^2 / 4 dependent shared-memory shifts a lane; the C entry's
//     `insertion` flag takes it at any K, to time it beside the run merge.
//
// Numerics follow the reference as compiled: fedavg dequantizes with one
// rounding (__fmul_rn) and accumulates one row at a time with a fused
// multiply-add, acc = fma(q * s, w, acc) in k order from acc = 0, which is
// what XLA emits for the reference's sum(rows * w); the sort methods are
// sort_net.cuh's; requantizing uses common.cuh's scale and rounding.
#include "common.cuh"
#include "sort_net.cuh"

namespace repro {

constexpr int FEDAVG = 0;
constexpr int LANES = 4;                       // consecutive lanes a thread
constexpr int AGG_THREADS = 128;               // block without quantize_out
constexpr int TILE_THREADS = BLOCK_D / LANES;  // 512: one block a tile
constexpr int ROW_CHUNK = 8;                   // fedavg rows a load batch

__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The requantized word of a thread's 4 lanes r of a tile held by one block
// of TILE_THREADS, and the tile's scale (common.cuh's quantizer over the
// tile's amax).
__device__ __forceinline__ void quantize_tile_lanes(const float (&r)[LANES],
                                                    unsigned lane0,
                                                    unsigned tile,
                                                    int8_t* __restrict__ qout,
                                                    float* __restrict__ sout) {
  __shared__ float red[TILE_THREADS / 32];
  float m = 0.0f;
#pragma unroll
  for (int l = 0; l < LANES; ++l) m = fmaxf(m, fabsf(r[l]));
  const TileQuantizer tq = tile_quantizer(block_max<TILE_THREADS / 32>(m, red));
  *reinterpret_cast<uint32_t*>(qout + lane0) = quantize4(r[0], r[1], r[2], r[3], tq);
  if (threadIdx.x == 0) sout[tile] = tq.scale;
}

// W == 0: fedavg; W = 8, 16, 32: cwmed or trimmed_mean (method) over K <= W
// rows.  QOUT: one block per tile, requantized output.
template <int W, bool QOUT>
__global__ void __launch_bounds__(QOUT ? TILE_THREADS : AGG_THREADS)
fused_agg_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 const float* __restrict__ w, float* __restrict__ out,
                 int8_t* __restrict__ qout, float* __restrict__ sout, int K,
                 unsigned nblk, int method, KeptSlots kept, float inv_keep,
                 uint32_t exponent_bytes) {
  const unsigned dpad = nblk * BLOCK_D;
  const unsigned lane0 = (blockIdx.x * blockDim.x + threadIdx.x) * LANES;
  const unsigned tile = lane0 / BLOCK_D;
  float r[LANES];

  if constexpr (W == 0) {
#pragma unroll
    for (int l = 0; l < LANES; ++l) r[l] = 0.0f;
    for (int c = 0; c < K; c += ROW_CHUNK) {
      uint32_t word[ROW_CHUNK];
      float sc[ROW_CHUNK], wt[ROW_CHUNK];
#pragma unroll
      for (int j = 0; j < ROW_CHUNK; ++j) {
        const bool in = c + j < K;
        const size_t k = static_cast<size_t>(c + j);
        word[j] = in ? load_word(q + k * dpad + lane0) : 0u;
        sc[j] = in ? s[k * nblk + tile] : 0.0f;
        wt[j] = in ? w[k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < ROW_CHUNK; ++j) {
        if (c + j < K) {
          const uint32_t b = word[j] ^ BYTE_BIAS;
#pragma unroll
          for (int l = 0; l < LANES; ++l)
            r[l] = __fmaf_rn(__fmul_rn(lane_value(b, l, exponent_bytes), sc[j]),
                             wt[j], r[l]);
        }
      }
    }
  } else {
    // Rows past K reload row K - 1 (no predicated loads) and become every
    // byte 1 times FLT_MAX, which sorts last: q * s is finite, for the
    // chain's scales are.
    const int8_t* qt = q + lane0;
    const float* st = s + tile;
    uint32_t word[W];
    float sc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const unsigned row = static_cast<unsigned>(min(k, K - 1));
      word[k] = load_word(qt + static_cast<size_t>(row) * dpad) ^ BYTE_BIAS;
      sc[k] = st[static_cast<size_t>(row) * nblk];
    }
    if (K < W) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k >= K) {
          word[k] = 0x01010101u ^ BYTE_BIAS;
          sc[k] = 3.40282347e38f;
        }
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      float v[W];
#pragma unroll
      for (int k = 0; k < W; ++k)
        v[k] = __fmul_rn(lane_value(word[k], l, exponent_bytes), sc[k]);
      sort_slots(v);
      r[l] = method == CWMED ? median_of_slots(v, K)
                             : trimmed_mean_of_finite_slots(v, kept, inv_keep);
    }
  }

  if constexpr (!QOUT) {
    *reinterpret_cast<float4*>(out + lane0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    quantize_tile_lanes(r, lane0, tile, qout, sout);
  }
}

// quantize_out after fused_lane_kernel: its f32 results x, a block of
// TILE_THREADS a tile, 4 lanes a thread, quantized as fused_agg_kernel's
// quantize_out form quantizes its own.
__global__ void __launch_bounds__(TILE_THREADS)
requantize_kernel(const float* __restrict__ x, int8_t* __restrict__ qout,
                  float* __restrict__ sout) {
  const unsigned lane0 = (blockIdx.x * TILE_THREADS + threadIdx.x) * LANES;
  const float4 v = *reinterpret_cast<const float4*>(x + lane0);
  const float r[LANES] = {v.x, v.y, v.z, v.w};
  quantize_tile_lanes(r, lane0, blockIdx.x, qout, sout);
}

// An int8 byte (as loaded, zero-extended) as an exact f32: b placed as
// b + 128 in the low mantissa bits of 2^23, minus 2^23 + 128, with no
// conversion instruction.
__device__ __forceinline__ float byte_value(uint32_t u) {
  return __fsub_rn(__uint_as_float(u ^ 0x4b000080u), 8388736.0f);
}

// 33 <= K <= 128: a lane's median or trimmed mean over its K rows, R runs
// of 32, one lane a thread, a block of T = MERGE_THREADS lanes, all in one
// tile.  The block first copies its K x T bytes of q and the tile's K
// scales into shared memory, all at once, a commit group a run (cp.async:
// a warp's bytes of a row are 32, and only so many fit a thread's
// registers, so loads of its own would leave too few bytes in flight to
// cover the memory's latency; the bytes sit in the last run's slots).
// Then, each run as soon as its rows have arrived, each thread
// dequantizes its lane's rows from there (rows past K become FLT_MAX,
// which sorts last), sorts them in registers and stores them to its column
// of `runs` (stride T); last it merges the R runs.
template <int R>
__global__ void __launch_bounds__(MERGE_THREADS)
fused_lane_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, int K, int nblk, int method,
                  int trim, float inv_keep) {
  constexpr int T = MERGE_THREADS, CHUNKS = T / 16;  // 16-byte copies a row
  extern __shared__ float runs[];
  __shared__ float scales[MERGE_MAX_K];
  const size_t dpad = static_cast<size_t>(nblk) * BLOCK_D;
  const unsigned first = blockIdx.x * T;
  const unsigned tile = first / BLOCK_D;
  uint8_t* slab = reinterpret_cast<uint8_t*>(runs + (R - 1) * RUN_SLOTS * T);
  for (int k = threadIdx.x; k < K; k += T)
    async_copy4(scales + k, s + static_cast<size_t>(k) * nblk + tile);
  for (int r = 0; r < R; ++r) {
    const int rows = min(K - r * RUN, RUN);
    for (int c = threadIdx.x; c < rows * CHUNKS; c += T) {
      const int k = r * RUN + c / CHUNKS, j = 16 * (c % CHUNKS);
      async_copy16(slab + k * T + j, q + k * dpad + first + j);
    }
    async_copies_commit();
  }
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int base = r * RUN, n = min(K - base, RUN);
    async_copies_wait(R - 1 - r);
    __syncthreads();  // every thread's copies of the run have landed
    // rows past K read bytes and scales no copy wrote (inside the slab and
    // the scales, which hold R * 32 rows), and are replaced
    const uint8_t* mine = slab + base * T + threadIdx.x;
    float v[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const float x = __fmul_rn(byte_value(mine[k * T]), scales[base + k]);
      v[k] = k < n ? x : 3.40282347e38f;
    }
    sort_run(v, n);
    if (r == R - 1) __syncthreads();  // every lane's bytes read
    store_run<FloatKey, T>(runs + threadIdx.x + r * RUN_SLOTS * T, v);
  }
  out[first + threadIdx.x] =
      merge_reduce<R, FloatKey, T>(runs + threadIdx.x, K, method, trim, inv_keep);
}

// K > 128, or any K with the `insertion` flag: one block per tile,
// L = blockDim.x threads, L lanes at a time.
// Shared memory: the K-deep columns (slot k of thread t at col[k * L + t],
// so a block's threads hit distinct banks), the tile's BLOCK_D results and
// its amax.
__global__ void fused_column_kernel(const int8_t* __restrict__ q,
                                    const float* __restrict__ s,
                                    float* __restrict__ out,
                                    int8_t* __restrict__ qout,
                                    float* __restrict__ sout, int K, int nblk,
                                    int method, int trim, float inv_keep) {
  extern __shared__ float smem[];
  const int L = blockDim.x, t = threadIdx.x, tile = blockIdx.x;
  float* col = smem + t;
  float* res = smem + static_cast<size_t>(K) * L;
  unsigned* amax = reinterpret_cast<unsigned*>(res + BLOCK_D);
  const size_t dpad = static_cast<size_t>(nblk) * BLOCK_D;
  const size_t first = static_cast<size_t>(tile) * BLOCK_D;
  if (t == 0) *amax = 0u;
  __syncthreads();
  float m = 0.0f;
  for (int at = t; at < BLOCK_D; at += L) {
    for (int k = 0; k < K; ++k)
      col[k * L] = __fmul_rn(static_cast<float>(q[k * dpad + first + at]),
                             s[static_cast<size_t>(k) * nblk + tile]);
    for (int a = 1; a < K; ++a) {
      const float key = col[a * L];
      int b = a - 1;
      while (b >= 0 && col[b * L] > key) {
        col[(b + 1) * L] = col[b * L];
        --b;
      }
      col[(b + 1) * L] = key;
    }
    float v;
    if (method == CWMED) {
      v = (K & 1) ? col[(K / 2) * L]
                  : __fmul_rn(0.5f, __fadd_rn(col[(K / 2 - 1) * L],
                                              col[(K / 2) * L]));
    } else {
      float sum = col[trim * L];
      for (int k = trim + 1; k < K - trim; ++k) sum = __fadd_rn(sum, col[k * L]);
      v = __fmul_rn(sum, inv_keep);
    }
    if (qout == nullptr) {
      out[first + at] = v;
    } else {
      res[at] = v;
      m = fmaxf(m, fabsf(v));
    }
  }
  if (qout == nullptr) return;
  // non-negative floats order as their bits do
  atomicMax(amax, __float_as_uint(m));
  __syncthreads();
  const float scale = tile_scale(__uint_as_float(*amax));
  for (int at = t; at < BLOCK_D; at += L)
    qout[first + at] = static_cast<int8_t>(quantize_bits(res[at], scale) & 0xffu);
  if (t == 0) sout[tile] = scale;
}


std::atomic<int> column_smem_granted[MAX_DEVICES];

int launch_column(const int8_t* q, const float* s, float* out, int8_t* qout,
                  float* sout, int K, int nblk, int method, int trim,
                  float inv_keep, cudaStream_t stream) {
  int dev = 0, optin = 0;
  int err = device_smem(&dev, &optin);
  if (err != cudaSuccess) return err;
  const long long fixed = 4LL * (BLOCK_D + 1), column = 4LL * K;
  int L = 256;
  while (L > 1 && fixed + column * L > optin) L >>= 1;
  if (fixed + column * L > optin) return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(fixed + column * L);
  err = allow_smem(fused_column_kernel, dev, bytes, column_smem_granted);
  if (err != cudaSuccess) return err;
  fused_column_kernel<<<nblk, L, bytes, stream>>>(q, s, out, qout, sout, K,
                                                  nblk, method, trim, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// fused_lane_kernel<R> into out, and with quantize_out (qout != nullptr)
// requantize_kernel from out into qout and sout.
template <int R>
int launch_lanes(const int8_t* q, const float* s, float* out, int8_t* qout,
                 float* sout, int K, int nblk, int method, int trim,
                 float inv_keep, cudaStream_t stream) {
  static std::atomic<int> granted[MAX_DEVICES];
  const int bytes = merge_smem_bytes(R, MERGE_THREADS);
  int dev = 0, optin = 0;
  int err = device_smem(&dev, &optin);
  if (err != cudaSuccess) return err;
  err = allow_smem(fused_lane_kernel<R>, dev, bytes, granted);
  if (err != cudaSuccess) return err;
  fused_lane_kernel<R><<<static_cast<unsigned>(nblk) * (BLOCK_D / MERGE_THREADS),
                         MERGE_THREADS, bytes, stream>>>(
      q, s, out, K, nblk, method, trim, inv_keep);
  err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess || qout == nullptr) return err;
  requantize_kernel<<<nblk, TILE_THREADS, 0, stream>>>(out, qout, sout);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_tiles(const int8_t* q, const float* s, const float* w, float* out,
                 int8_t* qout, float* sout, int K, int nblk, int method,
                 int trim, float inv_keep, cudaStream_t stream) {
  const KeptSlots kept = kept_slots(K, trim);
  if (qout != nullptr)
    fused_agg_kernel<W, true><<<nblk, TILE_THREADS, 0, stream>>>(
        q, s, w, out, qout, sout, K, nblk, method, kept, inv_keep,
        F32_EXPONENT_BYTES);
  else
    fused_agg_kernel<W, false>
        <<<nblk * (TILE_THREADS / AGG_THREADS), AGG_THREADS, 0, stream>>>(
            q, s, w, out, qout, sout, K, nblk, method, kept, inv_keep,
            F32_EXPONENT_BYTES);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// q: (K, nblk * 2048) int8, s: (K, nblk) f32, w: (K,) f32 normalized.
// quantize_out == 0: out (nblk * 2048,) f32 (qout, sout unused).
// quantize_out != 0: qout (nblk * 2048,) int8 and sout (nblk,) f32; the run
// merge also needs `out` as f32 scratch of nblk * 2048, which it writes
// before requantizing (a second launch, requantize_kernel).
// Any K for fedavg; cwmed and trimmed_mean take any K whose column fits one
// lane's shared memory, sorted by the design of sort_net.cuh's sort_path:
// K <= 32 in registers, 33 <= K <= 128 by the run merge, K > 128 by the
// insertion sort; insertion != 0 takes the insertion sort at any K
// (refused for fedavg).  With `path` non-null nothing is launched (the
// pointers may be null) and the design is written there: {design, size,
// whether `out` is needed as scratch}, design 0 for fedavg.  A row holds
// at most 2^20 tiles (2^31 lanes).  q and out must be 16-byte aligned.
extern "C" int repro_fused_agg(const void* q, const void* s, const void* w,
                               void* out, void* qout, void* sout, int K,
                               int nblk, int method, int trim,
                               int quantize_out, int insertion, int* path,
                               void* stream) {
  if (K <= 0 || nblk <= 0 || nblk > (1 << 20) || method < repro::FEDAVG ||
      method > repro::TRIMMED_MEAN)
    return cudaErrorInvalidValue;
  if (method == repro::TRIMMED_MEAN && (trim < 0 || 2 * trim >= K))
    return cudaErrorInvalidValue;
  if (method == repro::FEDAVG && insertion) return cudaErrorInvalidValue;
  const repro::SortPath sp = method == repro::FEDAVG
                                 ? repro::SortPath{repro::FEDAVG, 0}
                                 : repro::sort_path(K, insertion != 0);
  const bool scratch = quantize_out && sp.design == repro::RUN_MERGE;
  if (path) {
    path[0] = sp.design;
    path[1] = sp.size;
    path[2] = scratch;
    return cudaSuccess;
  }
  if (scratch && out == nullptr) return cudaErrorInvalidValue;
  if (method != repro::TRIMMED_MEAN) trim = 0;
  // f32(1 / kept), rounded as the device's __fdiv_rn rounds it
  const float inv_keep = 1.0f / static_cast<float>(K - 2 * trim);
  const int8_t* q8 = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  int8_t* qo = quantize_out ? static_cast<int8_t*>(qout) : nullptr;
  float* so = static_cast<float*>(sout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sp.design) {
    case repro::FEDAVG:
      return repro::launch_tiles<0>(q8, sf, wf, o, qo, so, K, nblk, method, trim, inv_keep, st);
    case repro::NETWORK:
      switch (sp.size) {
        case 8: return repro::launch_tiles<8>(q8, sf, wf, o, qo, so, K, nblk, method, trim, inv_keep, st);
        case 16: return repro::launch_tiles<16>(q8, sf, wf, o, qo, so, K, nblk, method, trim, inv_keep, st);
        default: return repro::launch_tiles<32>(q8, sf, wf, o, qo, so, K, nblk, method, trim, inv_keep, st);
      }
    case repro::RUN_MERGE:
      switch (sp.size) {
        case 2: return repro::launch_lanes<2>(q8, sf, o, qo, so, K, nblk, method, trim, inv_keep, st);
        case 3: return repro::launch_lanes<3>(q8, sf, o, qo, so, K, nblk, method, trim, inv_keep, st);
        default: return repro::launch_lanes<4>(q8, sf, o, qo, so, K, nblk, method, trim, inv_keep, st);
      }
    default:
      return repro::launch_column(q8, sf, o, qo, so, K, nblk, method, trim, inv_keep, st);
  }
}
