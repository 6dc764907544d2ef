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
// in one thread, whatever P, M, N or the output's tile: a client's result
// is the same bits in a call of 1 client or of 54.  Products whose K runs
// past a tile's edge multiply zeros (acc + (+-0) leaves acc, up to the sign
// of a zero sum).
//
// A long K with few outputs (a weight gradient summed over a batch's
// pixels: K = 25,088 for 9 x 32 outputs a client) would leave most of the
// card idle, so such a product is split: the caller picks `splits` from K
// alone (kernels/client_gemm.py), chunk s sums k in [s * k_chunk,
// (s + 1) * k_chunk) as above into a workspace, and a second kernel adds
// the chunks in order, acc = ((c_0 + c_1) + c_2) + ..., then the bias.
// The order is still fixed by K, never by P.
//
// A and B are read through arbitrary element strides, so transposed views
// (the backward's A^T and B^T) need no copy; the tile loads walk the
// operand's unit-stride axis when it has one.  Tiles: 64 x 64 outputs per
// block of 256 threads, 4 x 4 per thread, K in steps of 16 through shared
// memory; the grid is (N tiles, M tiles, P * splits).
//
// Bound on an H100: operations for the trainer's conv products (2 M N K
// flops at 67 Tflop/s f32 without tensor cores), bytes for the thin ones.
// This is a plain tiled SGEMM: no tensor cores (TF32 would round the
// inputs, and the port keeps TF32 off), no double buffering.
#include "common.cuh"

namespace repro {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_T = 4;                    // outputs a thread per axis
constexpr int GEMM_TY = GEMM_BM / GEMM_T;    // 16 thread rows
constexpr int GEMM_TX = GEMM_BN / GEMM_T;    // 16 thread columns

struct Strides {
  long long p, r, c;   // element strides of the client, row and column axes
};

// Loads a rows x cols tile of a (row, col)-strided operand into
// smem[col][row] (k-major for A, where rows are m and cols are k; for B,
// rows are k and cols n, stored smem[k][n] by the caller's swap).
template <int R, int C, bool K_MAJOR_ROWS>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          Strides s, int r0, int c0, int R_all,
                                          int C_all, float (*smem)[K_MAJOR_ROWS ? R : C]) {
  // K_MAJOR_ROWS: smem[c][r] (A: c = k, r = m); else smem[r][c] (B: r = k).
  const bool rows_fast = s.r == 1;
  for (int i = threadIdx.x; i < R * C; i += GEMM_THREADS) {
    const int r = rows_fast ? i % R : i / C;
    const int c = rows_fast ? i / R : i % C;
    const int gr = r0 + r, gc = c0 + c;
    const float v = (gr < R_all && gc < C_all)
                        ? src[gr * s.r + gc * s.c] : 0.0f;
    if (K_MAJOR_ROWS) smem[c][r] = v;
    else smem[r][c] = v;
  }
}

// Block (n tile, m tile, p * splits + s): chunk s of client p's product,
// written to C[(p * splits + s)] (the workspace when splits > 1, with no
// bias then).
__global__ void __launch_bounds__(GEMM_THREADS)
client_gemm_kernel(const float* __restrict__ A, Strides sa,
                   const float* __restrict__ B, Strides sb,
                   const float* __restrict__ bias, long long bias_p,
                   float* __restrict__ C, int M, int N, int K, int splits,
                   int k_chunk) {
  __shared__ float As[GEMM_BK][GEMM_BM];
  __shared__ float Bs[GEMM_BK][GEMM_BN];
  const long long p = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const float* Ap = A + p * sa.p + k_begin * sa.c;
  const float* Bp = B + p * sb.p + k_begin * sb.r;
  const int Kc = k_end - k_begin;
  const int ty = threadIdx.x / GEMM_TX, tx = threadIdx.x % GEMM_TX;
  float acc[GEMM_T][GEMM_T];
#pragma unroll
  for (int i = 0; i < GEMM_T; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_T; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < Kc; k0 += GEMM_BK) {
    load_tile<GEMM_BM, GEMM_BK, true>(Ap, sa, m0, k0, M, Kc, As);
    load_tile<GEMM_BK, GEMM_BN, false>(Bp, sb, k0, n0, Kc, N, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      float a[GEMM_T], b[GEMM_T];
#pragma unroll
      for (int i = 0; i < GEMM_T; ++i) a[i] = As[kk][ty + i * GEMM_TY];
#pragma unroll
      for (int j = 0; j < GEMM_T; ++j) b[j] = Bs[kk][tx + j * GEMM_TX];
#pragma unroll
      for (int i = 0; i < GEMM_T; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_T; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Cp = C + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < GEMM_T; ++i) {
    const int m = m0 + ty + i * GEMM_TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < GEMM_T; ++j) {
      const int n = n0 + tx + j * GEMM_TX;
      if (n >= N) continue;
      const float v = acc[i][j];
      Cp[static_cast<long long>(m) * N + n] =
          bias ? __fadd_rn(v, bias[p * bias_p + n]) : v;
    }
  }
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

}  // namespace repro

// C (P, M, N) contiguous f32 = A (P, M, K) @ B (P, K, N) (+ bias (P, N)).
// A and B are read through the given element strides (client, row,
// column); bias may be null, else row p starts at bias + p * bias_p and is
// contiguous in n.  With splits > 1, K is summed in chunks of k_chunk
// (splits = ceil(K / k_chunk)) into `ws`, (P, splits, M, N) f32, and the
// chunks are added in order into C.
extern "C" int repro_client_gemm(const void* a, long long sa_p, long long sa_m,
                                 long long sa_k, const void* b, long long sb_p,
                                 long long sb_k, long long sb_n,
                                 const void* bias, long long bias_p, void* c,
                                 void* ws, int P, int M, int N, int K,
                                 int splits, int k_chunk, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || K <= 0 || splits <= 0 || k_chunk <= 0 ||
      static_cast<long long>(splits) * k_chunk < K ||
      static_cast<long long>(splits - 1) * k_chunk >= K ||
      static_cast<long long>(P) * splits > 65535 || (splits > 1 && !ws))
    return cudaErrorInvalidValue;
  const long long mt = (M + repro::GEMM_BM - 1) / repro::GEMM_BM;
  if (mt > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + repro::GEMM_BN - 1) / repro::GEMM_BN,
                  static_cast<unsigned>(mt), P * splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  float* out = static_cast<float*>(c);
  float* partial = splits > 1 ? static_cast<float*>(ws) : out;
  repro::client_gemm_kernel<<<grid, repro::GEMM_THREADS, 0, s>>>(
      static_cast<const float*>(a), repro::Strides{sa_p, sa_m, sa_k},
      static_cast<const float*>(b), repro::Strides{sb_p, sb_k, sb_n},
      splits > 1 ? nullptr : bias_f, bias_p, partial, M, N, K, splits, k_chunk);
  if (splits > 1) {
    const long long MN = static_cast<long long>(M) * N;
    const long long blocks = (P * MN + repro::THREADS - 1) / repro::THREADS;
    repro::client_gemm_reduce_kernel<<<static_cast<unsigned>(blocks),
                                       repro::THREADS, 0, s>>>(
        partial, bias_f, bias_p, out, P, MN, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
