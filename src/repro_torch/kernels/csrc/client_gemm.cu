// Per-client matrix products of the local trainer: C[p] = A[p] @ B[p]
// (+ bias[p]) for a stack of P independent clients, every output a
// fixed-order FMA chain.
//
// The reference trains its P clients as one vmapped XLA program
// (src/repro/fl/client.py:45-56); XLA compiles one per-client program, so
// a client's update does not depend on how many clients share the call
// (tests/test_sharded_round.py:81-97 holds that at atol 0).  PyTorch's
// batched convolutions and matmuls choose their algorithm, blocking and
// split of the reduction by the whole call's shape, so a client's rows
// moved with P.  Here each output element is
//   acc = 0; for k in 0..K-1: acc = __fmaf_rn(A[p][m][k], B[p][k][n], acc)
//   C[p][m][n] = bias ? __fadd_rn(acc, bias[p][n]) : acc
// in one thread, whatever P, M, N, the path or the output's tile: a
// client's result is the same bits in a call of 1 client or of 54.
// Products whose K runs past a tile's edge multiply zeros (acc + (+-0)
// leaves acc, up to the sign of a zero sum).
//
// A long K with few outputs (a weight gradient summed over a batch's
// pixels: K = 25,088 for 9 x 32 outputs a client) would leave most of the
// card idle, so such a product is split: the caller picks `splits` from K
// alone (kernels/client_gemm.py), chunk s sums k in [s * k_chunk,
// (s + 1) * k_chunk) as above into a workspace, and a second kernel adds
// the chunks in order, acc = ((c_0 + c_1) + c_2) + ..., then the bias.
// The order is still fixed by K, never by P.
//
// With `ones_row` the output has one more row, M, whose A is all ones: the
// bias gradient sum_k B[k][n] of a linear layer, folded into its weight
// gradient's launch so B is read once.  fma(1, b, acc) is RN(acc + b), so
// that row is a chain of __fadd_rn over k, computed by one extra warp of
// the blocks whose M tile is the first.
//
// Bound on an H100: operations for the trainer's conv products (2 M N K
// flops at 67 Tflop/s f32 without tensor cores: TF32 would round the
// inputs, and the port keeps TF32 off), bytes for the thin ones.  Paths:
//   tile    a register-blocked SGEMM.  A and B are staged in shared memory
//           through a ring of cp.async copies (16 bytes along the
//           operand's unit-stride axis where the strides and the base
//           allow, else 4 bytes an element through any strides), each
//           tile kept in the layout it has in memory: A k-major [BK][BM]
//           when m is its unit-stride axis (the backward's A^T), else
//           [BM][BK + 4]; B [BK][BN] or [BN][BK + 4] (the backward's B^T).
//           Fragments are read as float4 along the stored axis (four k
//           steps at once along k), so every layout costs one 16-byte
//           shared load a 4 x 4 block of FMAs at the widest tiles.  Each
//           thread holds a TM x TN block of outputs, rows interleaved
//           across the tile where A is k-major in memory and in runs of 4
//           where it is m-major (the same for columns), which keeps the
//           16-byte shared loads of a quarter-warp on distinct banks or
//           one broadcast address.  The tile is picked from the shape
//           and layout (launch_layout): every tile computes the same
//           chains.
//   stream  K <= 16 (conv1's forward, K = 9): no reduction to block, a
//           pass over bytes.  Rows of A are staged in shared memory 256 at
//           a time (one contiguous span where they allow), a thread keeps
//           B's 4 columns of its outputs in registers, and each row's 4
//           outputs go out as one 16-byte store: a warp writes 4 whole
//           rows of 32 outputs.
// A split product's chunks are added by client_gemm_reduce_kernel; adding
// them in the tile kernel, by the block that drew a tile's last atomic
// ticket, measured slower on the trainer's three split forms (PERF.md).
#include "common.cuh"

namespace repro {

struct Strides {
  long long p, r, c;   // element strides of the client, row and column axes
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies an OUT x IN tile of a strided operand into dst[o * LD + i]:
// element (o, i) is src[(o0 + o) * s_out + (i0 + i) * s_in], zero outside
// o < o_all, i < i_all.  IN is the axis stored contiguously; with `vec`
// (s_in == 1, s_out % 4 == 0, src 16-byte aligned) it is read 16 bytes at
// a time, else one element at a time through both strides.
template <int OUT, int IN, int LD, int NT>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long s_out, long long s_in,
                                          int o0, int i0, int o_all, int i_all,
                                          bool vec) {
  static_assert(IN % 4 == 0 && LD % 4 == 0, "16-byte rows");
  constexpr int CHUNKS = OUT * IN / 4;
#pragma unroll
  for (int c0 = 0; c0 < CHUNKS; c0 += NT) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    if (CHUNKS % NT != 0 && c >= CHUNKS) break;
    const int o = c / (IN / 4), i = (c % (IN / 4)) * 4;
    float* d = dst + o * LD + i;
    const int go = o0 + o, gi = i0 + i;
    const bool row_ok = go < o_all;
    if (vec) {
      const int valid = row_ok ? max(0, min(4, i_all - gi)) : 0;
      cp_async16(d, valid ? src + go * s_out + gi : src, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && gi + e < i_all;
        cp_async4(d + e, ok ? src + go * s_out + (gi + e) * s_in : src,
                  ok ? 4 : 0);
      }
    }
  }
}

// One tile configuration: a BM x BN block of outputs, K in steps of BK
// through STAGES shared-memory stages, TM x TN outputs a thread, and MINB
// blocks an SM asked of the register allocator (at 8 x 8 a thread it
// sets the occupancy: conv2's forward runs faster capped to 3 blocks of
// 128 threads than at the 2 its uncapped registers allow; PERF.md).
// A_KFAST: A's unit-stride axis is k (stored [BM][BK + 4]), else m
// ([BK][BM]).  B_KFAST: B's is k ([BN][BK + 4]), else n ([BK][BN]).
// ONES: one more warp computes the ones row.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_, int MINB_,
          bool A_KFAST_, bool B_KFAST_, bool ONES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr bool A_KFAST = A_KFAST_, B_KFAST = B_KFAST_, ONES = ONES_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static constexpr int COMPUTE = TX * TY;
  static constexpr int THREADS = COMPUTE + (ONES ? 32 : 0);
  static constexpr int A_OUT = A_KFAST ? BM : BK;
  static constexpr int A_IN = A_KFAST ? BK : BM;
  static constexpr int A_LD = A_IN + (A_KFAST ? 4 : 0);
  static constexpr int B_OUT = B_KFAST ? BN : BK;
  static constexpr int B_IN = B_KFAST ? BK : BN;
  static constexpr int B_LD = B_IN + (B_KFAST ? 4 : 0);
  static constexpr int A_STAGE = A_OUT * A_LD, B_STAGE = B_OUT * B_LD;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;
  static_assert(BM % TM == 0 && BN % TN == 0 && BK % 4 == 0, "tile shape");
  static_assert(A_KFAST || TM % 4 == 0, "m-major A is read in runs of 4");
  static_assert(B_KFAST || TN % 4 == 0, "n-major B is read in runs of 4");
  static_assert(COMPUTE % 32 == 0 && STAGES >= 2, "whole warps");
};

// Four consecutive floats of shared memory (16-byte aligned).
__device__ __forceinline__ void lds4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Stage k0's A and B tiles of a block into (as, bs).
template <class T>
__device__ __forceinline__ void load_stage(float* as, float* bs,
                                           const float* Ap, Strides sa,
                                           const float* Bp, Strides sb, int m0,
                                           int n0, int k0, int M, int N,
                                           int Kc, bool vec_a, bool vec_b) {
  if constexpr (T::A_KFAST)
    load_tile<T::A_OUT, T::A_IN, T::A_LD, T::THREADS>(as, Ap, sa.r, sa.c, m0,
                                                      k0, M, Kc, vec_a);
  else
    load_tile<T::A_OUT, T::A_IN, T::A_LD, T::THREADS>(as, Ap, sa.c, sa.r, k0,
                                                      m0, Kc, M, vec_a);
  if constexpr (T::B_KFAST)
    load_tile<T::B_OUT, T::B_IN, T::B_LD, T::THREADS>(bs, Bp, sb.c, sb.r, n0,
                                                      k0, N, Kc, vec_b);
  else
    load_tile<T::B_OUT, T::B_IN, T::B_LD, T::THREADS>(bs, Bp, sb.r, sb.c, k0,
                                                      n0, Kc, N, vec_b);
}

// Block (tile, split, p): chunk `split` of client p's product over the
// tile's outputs, written to C[p * splits + split] ((Mo, N) each, Mo = M +
// ONES; the workspace when splits > 1, with no bias then).  Tiles are
// numbered M-tile first, so neighbouring blocks share B's columns.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
client_gemm_tile_kernel(const float* __restrict__ A, Strides sa,
                        const float* __restrict__ B, Strides sb,
                        const float* __restrict__ bias, long long bias_p,
                        float* __restrict__ C, int M, int N, int K,
                        int k_chunk, int m_tiles, bool vec_a, bool vec_b) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr int TX = T::TX, TY = T::TY, STAGES = T::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * T::A_STAGE;

  const int mt = blockIdx.x % m_tiles, nt = blockIdx.x / m_tiles;
  const int m0 = mt * BM, n0 = nt * BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const long long p = blockIdx.z;
  const int k_begin = split * k_chunk;
  const int Kc = min(K, k_begin + k_chunk) - k_begin;
  const float* Ap = A + p * sa.p + k_begin * sa.c;
  const float* Bp = B + p * sb.p + k_begin * sb.r;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const bool ones_warp = T::ONES && tid >= T::COMPUTE && mt == 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  constexpr int OQ = (BN + 31) / 32;   // ones-row columns a lane
  float ones_acc[OQ];
#pragma unroll
  for (int q = 0; q < OQ; ++q) ones_acc[q] = 0.0f;

  const int k_tiles = (Kc + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles)
      load_stage<T>(As + s * T::A_STAGE, Bs + s * T::B_STAGE, Ap, sa, Bp, sb,
                    m0, n0, s * BK, M, N, Kc, vec_a, vec_b);
    cp_async_commit();
  }
  for (int t = 0; t < k_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in step t - 1, which every thread
    // has finished (the barrier above)
    const int pf = t + STAGES - 1;
    if (pf < k_tiles)
      load_stage<T>(As + (pf % STAGES) * T::A_STAGE,
                    Bs + (pf % STAGES) * T::B_STAGE, Ap, sa, Bp, sb, m0, n0,
                    pf * BK, M, N, Kc, vec_a, vec_b);
    cp_async_commit();
    const float* as = As + (t % STAGES) * T::A_STAGE;
    const float* bs = Bs + (t % STAGES) * T::B_STAGE;
    if (tid < T::COMPUTE) {
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 4) {
        // a[i][kk], b[j][kk]: four k steps of the thread's rows and columns
        float a[TM][4], b[TN][4];
        if constexpr (T::A_KFAST) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            lds4(as + (ty + i * TY) * T::A_LD + k0, a[i]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int g = 0; g < TM / 4; ++g) {
              float v[4];
              lds4(as + (k0 + kk) * T::A_LD + g * TY * 4 + ty * 4, v);
#pragma unroll
              for (int e = 0; e < 4; ++e) a[g * 4 + e][kk] = v[e];
            }
        }
        if constexpr (T::B_KFAST) {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            lds4(bs + (tx + j * TX) * T::B_LD + k0, b[j]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int g = 0; g < TN / 4; ++g) {
              float v[4];
              lds4(bs + (k0 + kk) * T::B_LD + g * TX * 4 + tx * 4, v);
#pragma unroll
              for (int e = 0; e < 4; ++e) b[g * 4 + e][kk] = v[e];
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = __fmaf_rn(a[i][kk], b[j][kk], acc[i][j]);
      }
    } else if (ones_warp) {
      const int lane = tid - T::COMPUTE;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk)
#pragma unroll
        for (int q = 0; q < OQ; ++q) {
          const int n = lane + 32 * q;
          if (n < BN)
            ones_acc[q] = __fadd_rn(
                ones_acc[q], T::B_KFAST ? bs[n * T::B_LD + kk]
                                        : bs[kk * T::B_LD + n]);
        }
    }
  }
  cp_async_wait<0>();

  const int Mo = M + (T::ONES ? 1 : 0);
  float* Cp = C + (p * splits + split) * static_cast<long long>(Mo) * N;
  const float* bp = bias ? bias + p * bias_p : nullptr;
  if (tid < T::COMPUTE) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (T::A_KFAST ? ty + i * TY
                                     : (i / 4) * TY * 4 + ty * 4 + i % 4);
      if (m >= M) continue;
      float* row = Cp + static_cast<long long>(m) * N;
      if (!T::B_KFAST && N % 4 == 0) {
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const int n = n0 + g * TX * 4 + tx * 4;
          if (n >= N) continue;
          float4 v = make_float4(acc[i][g * 4], acc[i][g * 4 + 1],
                                 acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
          if (bp) {
            v.x = __fadd_rn(v.x, bp[n]);
            v.y = __fadd_rn(v.y, bp[n + 1]);
            v.z = __fadd_rn(v.z, bp[n + 2]);
            v.w = __fadd_rn(v.w, bp[n + 3]);
          }
          *reinterpret_cast<float4*>(row + n) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + (T::B_KFAST ? tx + j * TX
                                         : (j / 4) * TX * 4 + tx * 4 + j % 4);
          if (n < N) row[n] = bp ? __fadd_rn(acc[i][j], bp[n]) : acc[i][j];
        }
      }
    }
  } else if (ones_warp) {
    const int lane = tid - T::COMPUTE;
    float* row = Cp + static_cast<long long>(M) * N;
#pragma unroll
    for (int q = 0; q < OQ; ++q) {
      const int n = n0 + lane + 32 * q;
      if (lane + 32 * q < BN && n < N)
        row[n] = bp ? __fadd_rn(ones_acc[q], bp[n]) : ones_acc[q];
    }
  }
}

// K <= STREAM_KMAX, N % 4 == 0, N <= STREAM_NMAX: the block walks tiles
// of STREAM_ROWS rows of client p (blockIdx.y), tile blockIdx.x, then
// gridDim.x further, each staged in shared memory [row][K] through two
// stages of cp.async copies: 16 bytes at a time along the tile's flat span
// where A's rows are contiguous and consecutive (`flat`), else one
// element at a time through the strides.
// Thread (r, q) keeps B's columns 4q .. 4q + 3 (K x 4) and their bias in
// registers and computes those 4 outputs of rows r, r + R, ... of the
// tile, R = THREADS / (N / 4), each written as one 16-byte store.
constexpr int STREAM_ROWS = 256;
constexpr int STREAM_KMAX = 16;
constexpr int STREAM_NMAX = 128;

// Rows [t * STREAM_ROWS, ...) of A (at most STREAM_ROWS, fewer at the
// end) into dst[row * K + k].
__device__ __forceinline__ void stream_rows(float* dst, const float* Ap,
                                            Strides sa, int t, int M, int K,
                                            bool flat) {
  const int m0 = t * STREAM_ROWS;
  const int rows = min(STREAM_ROWS, M - m0);
  if (flat) {
    const float* src = Ap + static_cast<long long>(m0) * K;
    const int len = rows * K;
    for (int c = 4 * threadIdx.x; c < len; c += 4 * THREADS)
      cp_async16(dst + c, src + c, 4 * min(4, len - c));
  } else {
    for (int e = threadIdx.x; e < STREAM_ROWS * K; e += THREADS) {
      const int row = e / K, k = e % K;
      const bool ok = row < rows;
      cp_async4(dst + e, ok ? Ap + (m0 + row) * sa.r + k * sa.c : Ap,
                ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
client_gemm_stream_kernel(const float* __restrict__ A, Strides sa,
                          const float* __restrict__ B, Strides sb,
                          const float* __restrict__ bias, long long bias_p,
                          float* __restrict__ C, int M, int N, int K,
                          bool flat) {
  __shared__ __align__(16) float As[2][STREAM_ROWS * STREAM_KMAX];
  const int quads = N / 4;
  const int R = THREADS / quads;
  const int r = threadIdx.x / quads, q = threadIdx.x % quads;
  const long long p = blockIdx.y;
  const float* Ap = A + p * sa.p;
  const int tiles = (M + STREAM_ROWS - 1) / STREAM_ROWS;

  float b[STREAM_KMAX][4], bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool computes = r < R && q * 4 < N;
  if (computes) {
    const float* Bp = B + p * sb.p + 4 * q * sb.c;
#pragma unroll
    for (int k = 0; k < STREAM_KMAX; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[k][c] = k < K ? Bp[k * sb.r + c * sb.c] : 0.0f;
    if (bias)
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bias[p * bias_p + 4 * q + c];
  }
  float4* Cp = reinterpret_cast<float4*>(C + p * static_cast<long long>(M) * N);

  int stage = 0;
  if (blockIdx.x < tiles) stream_rows(As[0], Ap, sa, blockIdx.x, M, K, flat);
  cp_async_commit();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t + gridDim.x < tiles)
      stream_rows(As[stage ^ 1], Ap, sa, t + gridDim.x, M, K, flat);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (computes) {
      const float* as = As[stage];
      const int m0 = t * STREAM_ROWS;
      for (int row = r; row < STREAM_ROWS && m0 + row < M; row += R) {
        const float* ar = as + row * K;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < STREAM_KMAX; ++k) {
          if (k >= K) break;
          const float av = ar[k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = __fmaf_rn(av, b[k][c], acc[c]);
        }
        if (bias)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], bv[c]);
        Cp[static_cast<long long>(m0 + row) * quads + q] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();   // the stage is refilled by the next step's load
    stage ^= 1;
  }
  cp_async_wait<0>();
}

// C[p][i] = ((ws[p][0][i] + ws[p][1][i]) + ...) + bias[p][i % N], one
// thread an output.
__global__ void __launch_bounds__(THREADS)
client_gemm_reduce_kernel(const float* __restrict__ ws,
                          const float* __restrict__ bias, long long bias_p,
                          float* __restrict__ C, long long P, long long MN,
                          int N, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= P * MN) return;
  const long long p = i / MN, j = i % MN;
  const float* w = ws + p * splits * MN + j;
  float acc = w[0];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, w[s * MN]);
  C[i] = bias ? __fadd_rn(acc, bias[p * bias_p + j % N]) : acc;
}

struct Args {
  const float* a;
  Strides sa;
  const float* b;
  Strides sb;
  const float* bias;
  long long bias_p;
  float* out;      // C, or the workspace when splits > 1
  int P, M, N, K, splits, k_chunk;
  bool vec_a, vec_b;
};

template <class T>
int launch_tile(const Args& x, cudaStream_t s) {
  static std::atomic<int> granted[MAX_DEVICES];
  int dev = 0, optin = 0;
  int err = device_smem(&dev, &optin);
  if (err != cudaSuccess) return err;
  if (T::SMEM_BYTES > optin) return cudaErrorInvalidValue;
  err = allow_smem(client_gemm_tile_kernel<T>, dev, T::SMEM_BYTES, granted);
  if (err != cudaSuccess) return err;
  const int m_tiles = (x.M + T::BM - 1) / T::BM;
  const long long tiles =
      static_cast<long long>(m_tiles) * ((x.N + T::BN - 1) / T::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), x.splits, x.P);
  client_gemm_tile_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
      x.a, x.sa, x.b, x.sb, x.splits > 1 ? nullptr : x.bias, x.bias_p, x.out,
      x.M, x.N, x.K, x.k_chunk, m_tiles, x.vec_a, x.vec_b);
  return cudaSuccess;
}

// M at least this takes the 128-row tiles
constexpr int WIDE_M = 512;

inline int padded(int n, int tile) { return (n + tile - 1) / tile * tile; }

// Launches T, or with `path` writes its BM and BN there and launches
// nothing.
template <class T>
int take(const Args& x, cudaStream_t s, int* path) {
  if (!path) return launch_tile<T>(x, s);
  path[0] = T::BM;
  path[1] = T::BN;
  return cudaSuccess;
}

// The tile table and the choice among its rows, Tile<BM, BN, BK, TM, TN,
// STAGES, MINB, ...>: a row is chosen from M, N and the layout alone
// (never P), and a layout can only choose a row built for it.
template <bool AK, bool BK_, bool ONES>
int launch_layout(const Args& x, cudaStream_t s, int* path) {
  if constexpr (AK && !BK_ && !ONES) {
    if (x.M >= WIDE_M && x.N >= 64)     // forward products
      return take<Tile<128, 64, 16, 8, 8, 3, 3, AK, BK_, ONES>>(x, s, path);
    if (x.N >= 128)                     // thin forward products
      return take<Tile<32, 128, 16, 4, 8, 4, 3, AK, BK_, ONES>>(x, s, path);
  }
  if constexpr (AK && BK_ && !ONES) {
    if (x.M >= WIDE_M && x.N >= 96)     // input gradients
      return take<Tile<128, 96, 16, 4, 12, 4, 2, AK, BK_, ONES>>(x, s, path);
  }
  if constexpr (!AK && !BK_) {
    if (x.M + ONES <= 16 && x.N <= 32)  // thin weight gradients
      return take<Tile<16, 32, 32, 4, 4, 4, 1, AK, BK_, ONES>>(x, s, path);
    if (x.M >= 64 && x.N >= 64) {
      // weight gradients: the 48- or the 64-row tile, whichever pads M
      // less (ties: 48)
      if (padded(x.M, 48) <= padded(x.M, 64))
        return take<Tile<48, 64, 16, 4, 8, 4, 4, AK, BK_, ONES>>(x, s, path);
      return take<Tile<64, 64, 16, 4, 4, 4, 3, AK, BK_, ONES>>(x, s, path);
    }
  }
  // any layout, small
  return take<Tile<32, 64, 16, 4, 4, 4, 3, AK, BK_, ONES>>(x, s, path);
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The unit-stride axis of a (client, row, column) operand read 16 bytes
// at a time: it, the other axis, the clients and the base on 16-byte
// boundaries (k_chunk and every tile origin are multiples of 4).
inline bool vec16(const void* ptr, long long s_p, long long s_unit,
                  long long s_other, int splits, int k_chunk) {
  return aligned16(ptr) && s_p % 4 == 0 && s_unit == 1 && s_other % 4 == 0 &&
         (splits == 1 || k_chunk % 4 == 0);
}

template <bool AK>
int launch_tiles(const Args& x, bool b_kfast, bool ones, cudaStream_t s,
                 int* path) {
  if (b_kfast)
    return ones ? launch_layout<AK, true, true>(x, s, path)
                : launch_layout<AK, true, false>(x, s, path);
  return ones ? launch_layout<AK, false, true>(x, s, path)
              : launch_layout<AK, false, false>(x, s, path);
}

}  // namespace repro

// C (P, M + ones_row, N) contiguous f32 = [A; 1] (P, M (+ 1), K) @ B (P,
// K, N) (+ bias (P, N)).  A and B are read through the given element
// strides (client, row, column); bias may be null, else row p starts at
// bias + p * bias_p and is contiguous in n.  With splits > 1, K is summed
// in chunks of k_chunk (splits = ceil(K / k_chunk)) into `ws`, (P, splits,
// M + ones_row, N) f32, and the chunks are added in order into C.
// The path is chosen here from M, N, K, the strides and the base
// addresses, never from P: the stream path where K <= 16, N % 4 == 0, N
// <= 128 and there is no ones row, else a tile of launch_layout's table
// with A staged along k or m, B along k or n (whichever is its
// unit-stride axis), 16 bytes at a time where vec16 allows.  With `path`
// non-null nothing is launched (c and ws may be null) and the path is
// written there: {BM, BN (0, 0 for the stream path), A along k, B along
// k, A 16 bytes, B 16 bytes}.
extern "C" int repro_client_gemm(const void* a, long long sa_p, long long sa_m,
                                 long long sa_k, const void* b, long long sb_p,
                                 long long sb_k, long long sb_n,
                                 const void* bias, long long bias_p, void* c,
                                 void* ws, int P, int M, int N, int K,
                                 int splits, int k_chunk, int ones_row,
                                 int* path, void* stream) {
  if (P <= 0 || P > 65535 || M <= 0 || N <= 0 || K <= 0 || splits <= 0 ||
      splits > 65535 || k_chunk <= 0 ||
      static_cast<long long>(splits) * k_chunk < K ||
      static_cast<long long>(splits - 1) * k_chunk >= K ||
      (!path && (!c || (splits > 1 && !ws))))
    return cudaErrorInvalidValue;
  using repro::vec16;
  const bool a_kfast = !(M > 1 && sa_m == 1 && sa_k != 1);
  const bool b_kfast = N > 1 && sb_k == 1 && sb_n != 1;
  const bool streaming = K <= repro::STREAM_KMAX && N % 4 == 0 &&
                      N <= repro::STREAM_NMAX && !ones_row && splits == 1;
  // the stream path reads A's rows as one span where they are contiguous
  // and consecutive
  const bool vec_a =
      streaming ? repro::aligned16(a) && sa_p % 4 == 0 && sa_k == 1 && sa_m == K
      : a_kfast ? vec16(a, sa_p, sa_k, sa_m, splits, k_chunk)
                : vec16(a, sa_p, sa_m, sa_k, splits, k_chunk);
  const bool vec_b = b_kfast ? vec16(b, sb_p, sb_k, sb_n, splits, k_chunk)
                             : vec16(b, sb_p, sb_n, sb_k, splits, k_chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  float* out = static_cast<float*>(c);
  const repro::Args x{static_cast<const float*>(a), repro::Strides{sa_p, sa_m, sa_k},
                      static_cast<const float*>(b), repro::Strides{sb_p, sb_k, sb_n},
                      bias_f, bias_p, splits > 1 ? static_cast<float*>(ws) : out,
                      P, M, N, K, splits, k_chunk, vec_a, vec_b};
  if (path) {
    path[0] = path[1] = 0;
    path[2] = a_kfast;
    path[3] = b_kfast;
    path[4] = vec_a;
    path[5] = vec_b;
  }
  if (streaming) {
    if (path) return cudaSuccess;
    // about four tiles a block, so each prefetches while it computes
    const int tiles = (M + repro::STREAM_ROWS - 1) / repro::STREAM_ROWS;
    const dim3 grid((tiles + 3) / 4, P);
    repro::client_gemm_stream_kernel<<<grid, repro::THREADS, 0, s>>>(
        x.a, x.sa, x.b, x.sb, bias_f, bias_p, out, M, N, K, x.vec_a);
  } else {
    const int err =
        a_kfast ? repro::launch_tiles<true>(x, b_kfast, ones_row, s, path)
                : repro::launch_tiles<false>(x, b_kfast, ones_row, s, path);
    if (err != cudaSuccess || path) return err;
    if (splits > 1) {
      const long long MN = static_cast<long long>(M + (ones_row ? 1 : 0)) * N;
      const long long blocks = (P * MN + repro::THREADS - 1) / repro::THREADS;
      repro::client_gemm_reduce_kernel<<<static_cast<unsigned>(blocks),
                                         repro::THREADS, 0, s>>>(
          x.out, bias_f, bias_p, out, P, MN, N, splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
