// W8A8 GEMM with int32 accumulation and the fused ITA epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/int8_gemm/kernel.py, int8_gemm_pallas
//   (body _gemm_kernel): y = requantize(act(x_q @ w_q + bias)) → int8, with
//   an optional int_relu before and int_gelu_i8 after the requantization.
// Contract: bit-exact with repro_torch/kernels/int8_gemm/ref.py, which
//   ports the reference's int32 arithmetic (wrapping, XLA shift semantics).
//
// What bounds it: the main path calls it at decode, with M = the number of
//   serving slots (1..8) and K×N = a whole weight matrix. Every weight byte
//   is used M times, so the card's memory rate bounds it (about 204 MB of
//   int8 weights per glm4-9b layer); arithmetic is a few dp4a per byte.
// What the design does about it: weights are read once, in row order, as
//   4-byte words that neighbouring threads take from neighbouring
//   addresses; x (M rows, a few KB) is re-read from L1/L2. A block owns
//   32 output columns and 8 rows and splits K over its 32 warps' lanes
//   ("k-slices"), so even N = 4096 spreads over 128 blocks; partial sums
//   meet in shared memory for the epilogue. Each thread turns four
//   row-words into four column-words with __byte_perm and feeds __dp4a.
//   Ragged M and N are masked; K and N not multiples of 4 (or an unaligned
//   x) take the byte-wise path of the same kernel.
//   Tensor-core int8 MMA (wgmma/mma.sync), TMA and split-K are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;              // output rows per block
constexpr int COLS = 4;            // output columns per thread
constexpr int CT = 8;              // column threads per block
constexpr int BN = CT * COLS;      // 32 output columns per block
constexpr int KS = 32;             // k-slices per block
constexpr int THREADS = CT * KS;   // 256 = BM * BN (one output per thread)

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

// int32 arithmetic with the reference's wrap-around (and XLA's shift rules)
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int shl32(int v, int s) {  // s >= 0
  return s >= 32 ? 0 : (int)((unsigned)v << s);
}
__device__ __forceinline__ int sra32(int v, int s) {  // s >= 0
  return v >> (s > 31 ? 31 : s);
}
__device__ __forceinline__ int abs32(int v) {
  return v < 0 ? (int)(0u - (unsigned)v) : v;
}

// core/quant.py round_shift: arithmetic right shift with round-half-away;
// a negative s shifts left
__device__ int round_shift(int v, int s) {
  if (s > 0) {
    int half = shl32(1, s - 1);
    return sra32(add32(v, mul32(v >= 0 ? 1 : -1, half)), s);
  }
  if (s == 0) return v;
  return shl32(v, -s);
}

// core/quant.py requantize. Only the lane the reference keeps is computed;
// acc*m of a large acc (which overflows int32) is never formed.
__device__ int requantize(int acc, int m, int shift) {
  int y;
  int a = abs32(acc);
  if (a < (1 << 16)) {
    y = round_shift(mul32(acc, m), shift);
  } else {
    int bits = __float_as_int((float)a);   // magnitude exponent by bitcast
    int e = ((bits >> 23) & 0xFF) - 126;
    int pre = max(e - 15, 0);
    int acc_n = round_shift(acc, pre);
    if (shift - pre < 0) {
      y = acc >= 0 ? 127 : -127;           // saturated
    } else {
      y = round_shift(mul32(acc_n, m), shift - pre);
    }
  }
  return min(max(y, -127), 127);
}

// core/ita.py int_gelu_i8 with its host-folded constants
__device__ int int_gelu_i8(int q, int qb, int qc, int one, int gm, int gshift) {
  int sgn = (q > 0) - (q < 0);
  int q_abs = min(abs32(q), -qb);
  int l = add32(q_abs, qb);
  int q_erf = mul32(sgn, add32(mul32(l, l), qc));
  int val = mul32(q, add32(q_erf, one));
  return requantize((int)(0u - (unsigned)val), gm, gshift);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xFF) | ((b1 & 0xFF) << 8) | ((b2 & 0xFF) << 16) |
         ((unsigned)(b3 & 0xFF) << 24);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int* __restrict__ bias, const int* __restrict__ mult,
                 const int* __restrict__ shift, int8_t* __restrict__ out,
                 int M, int K, int N, int act, int qb, int qc, int one,
                 int gm, int gshift) {
  __shared__ int part[KS][BM][BN];
  const int tc = threadIdx.x % CT;   // column group of this thread
  const int ks = threadIdx.x / CT;   // k-slice of this thread
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN + tc * COLS;
  const int rows = min(BM, M - m0);

  int acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0;

  const int k4n = (K + 3) / 4;
#pragma unroll 2
  for (int k4 = ks; k4 < k4n; k4 += KS) {
    const int k = 4 * k4;
    int col[COLS];
    if (VEC) {
      if (n0 < N) {
        const int* wp = reinterpret_cast<const int*>(w + (size_t)k * N + n0);
        const size_t stride = (size_t)N / 4;
        int w0 = __ldg(wp), w1 = __ldg(wp + stride);
        int w2 = __ldg(wp + 2 * stride), w3 = __ldg(wp + 3 * stride);
        // 4×4 byte transpose: row-words (one k, four n) → column-words
        int lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
        int hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
        col[0] = __byte_perm(lo01, lo23, 0x5410);
        col[1] = __byte_perm(lo01, lo23, 0x7632);
        col[2] = __byte_perm(hi01, hi23, 0x5410);
        col[3] = __byte_perm(hi01, hi23, 0x7632);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) col[c] = 0;
      }
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        int n = n0 + c, b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          b[r] = (n < N && k + r < K) ? (int)w[(size_t)(k + r) * N + n] : 0;
        col[c] = pack4(b[0], b[1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < rows) {
        const int8_t* xr = x + (size_t)(m0 + m) * K;
        int xw;
        if (VEC) {
          xw = __ldg(reinterpret_cast<const int*>(xr + k));
        } else {
          xw = pack4(xr[k], k + 1 < K ? xr[k + 1] : 0,
                     k + 2 < K ? xr[k + 2] : 0, k + 3 < K ? xr[k + 3] : 0);
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[m][c] = __dp4a(xw, col[c], acc[m][c]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) part[ks][m][tc * COLS + c] = acc[m][c];
  __syncthreads();

  // one output per thread: sum the k-slices, then the fused epilogue
  const int m = threadIdx.x / BN, j = threadIdx.x % BN;
  const int row = m0 + m, n = blockIdx.x * BN + j;
  if (row >= M || n >= N) return;
  int sum = 0;
#pragma unroll 8
  for (int s = 0; s < KS; ++s) sum = add32(sum, part[s][m][j]);
  sum = add32(sum, bias[n]);
  if (act == ACT_RELU) sum = max(sum, 0);
  int y = requantize(sum, mult[n], shift[n]);
  if (act == ACT_GELU) y = int_gelu_i8(y, qb, qc, one, gm, gshift);
  out[(size_t)row * N + n] = (int8_t)y;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x [M, K] int8, w [K, N] int8, bias/mult/shift [N] int32 → out [M, N] int8
int int8_gemm_launch(const void* x, const void* w, const void* bias,
                     const void* mult, const void* shift, void* out, int M,
                     int K, int N, int act, int qb, int qc, int one, int gm,
                     int gshift, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bool vec = (K % 4 == 0) && (N % 4 == 0) &&
             ((uintptr_t)x % 4 == 0) && ((uintptr_t)w % 4 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  auto* xp = (const int8_t*)x;
  auto* wp = (const int8_t*)w;
  auto* bp = (const int*)bias;
  auto* mp = (const int*)mult;
  auto* sp = (const int*)shift;
  auto* op = (int8_t*)out;
  if (vec) {
    int8_gemm_kernel<true><<<grid, THREADS, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N, act, qb, qc, one, gm, gshift);
  } else {
    int8_gemm_kernel<false><<<grid, THREADS, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N, act, qb, qc, one, gm, gshift);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
