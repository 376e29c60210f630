// Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py ssd_scan_pallas (body
//   _ssd_kernel), and the state it keeps in VMEM scratch across the
//   sequential chunk axis, which this kernel also writes out (the serving
//   prefill needs it; the reference computes the same state through the xla
//   form of the op, ops._ssd_chunked_xla with return_state=True).
// Contract: allclose with repro_torch/kernels/ssd_scan/ref.py
//   ssd_scan_chunked_ref (float32 throughout, only the order of additions
//   differs). For each (batch, head), over chunks of L rows in order:
//     s        = cumsum(dta) over the chunk
//     y[t]     = sum_{tau<=t} (C_t.B_tau) exp(s_t - s_tau) x_tau
//              + exp(s_t) C_t.state
//     state    = exp(s_last) state + sum_tau exp(s_last - s_tau) B_tau x_tau^T
//   Head h reads group h / (H/G). A ragged last chunk (S % L != 0) acts as
//   the reference's zero padding (dta = 0, B = 0, outputs dropped): the
//   kernel just runs that chunk over its `len` real rows.
//
// What bounds it: operations. Per (head, chunk of L = 128) it does
//   2.L.L.N (C.B^T) + 2.L.L.P (scores.x) + 2.L.N.P (C.state)
//   + 2.L.N.P (B^T.x) flops = 10.5 MFLOP at mamba2-2.7b's N = 128, P = 64,
//   against 4.(2.L.P + 2.L.N + L) bytes = 197 KB of inputs and outputs:
//   about 50 flops per byte, above the card's float32 ridge (67 TFLOP/s
//   over 3.35 TB/s = 20). No TF32: the reference is float32, so the
//   products run on the CUDA cores.
// What the design does about it: one block per (batch, head, 64-column
//   tile of P) walks the chunks in order — the loop replaces the TPU's
//   sequential grid axis — with the state [N, 64] in shared memory. Each
//   chunk's C, B, x (and its cumulative decay) are staged in shared
//   memory once, and the four products run as register-tiled shared-memory
//   GEMMs (8x8 outputs per thread for C.B^T, 8x4 for the others, float4
//   loads, conflict-free: B's rows are padded to 132 floats). The scores
//   only exist for tau <= t (exp is never formed above the diagonal, so no
//   inf.0) and overwrite C's tile once C.state has been read, which keeps
//   the block at 196 KB of dynamic shared memory. mamba2-2.7b's one-prompt
//   prefill is 80 blocks on 132 SMs; C.B^T is recomputed by every head of
//   a group. Sharing it across the heads of a group, and tensor cores in
//   bf16x3 or TF32 where a looser contract allows, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 128;     // chunk rows
constexpr int NMAX = 128;     // state size N
constexpr int PT = 64;        // state columns per block
constexpr int BSTRIDE = NMAX + 4;   // B rows: 33 float4, odd → no conflicts
static_assert(LMAX == NMAX, "the scores tile reuses C's tile");

constexpr size_t SMEM_FLOATS =
    (size_t)LMAX * NMAX          // C [t][n], then scores [t][tau]
    + (size_t)LMAX * BSTRIDE     // B [tau][n]
    + (size_t)LMAX * PT          // x [tau][p]
    + (size_t)NMAX * PT          // state [n][p]
    + 3 * LMAX;                  // s, exp(s), exp(s_last - s)
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

struct Args {
  const float* dta;   // [B, H, S]
  const float* x;     // [B, H, S, P]
  const float* b;     // [B, G, S, N]
  const float* c;     // [B, G, S, N]
  float* y;           // [B, H, S, P]
  float* state_out;   // [B, H, N, P] or null
  int H, G, S, N, P, L;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);   // [LMAX][NMAX]
  float* bs = cs + LMAX * NMAX;                  // [LMAX][BSTRIDE]
  float* xs = bs + LMAX * BSTRIDE;               // [LMAX][PT]
  float* st = xs + LMAX * PT;                    // [NMAX][PT]
  float* sa = st + NMAX * PT;                    // [LMAX] cumsum of dta
  float* es = sa + LMAX;                         // [LMAX] exp(s_t)
  float* wv = es + LMAX;                         // [LMAX] exp(s_last - s_t)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % a.H;
  const int bb = bh / a.H;
  const int g = h / (a.H / a.G);
  const int p0 = blockIdx.y * PT;
  const int N = a.N, P = a.P, S = a.S;
  const int n4 = (N + 3) & ~3;

  const float* dta = a.dta + (size_t)bh * S;
  const float* xg = a.x + (size_t)bh * S * P;
  const float* bg = a.b + ((size_t)bb * a.G + g) * S * N;
  const float* cg = a.c + ((size_t)bb * a.G + g) * S * N;
  float* yg = a.y + (size_t)bh * S * P;

  // thread tiles: C.B^T rows t = ty + 16i, cols tau = tx + 16j (8x8);
  // the [rows, PT] products rows r = ty + 16i, cols 4tx..4tx+3 (8x4)
  const int ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < NMAX * PT; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += a.L) {
    const int len = min(a.L, S - c0);
    const int len4 = (len + 3) & ~3;
    __syncthreads();   // the previous chunk is done with every tile

    // -- stage the chunk: zero past its rows and past N / P ---------------
    for (int i = tid; i < LMAX * NMAX; i += THREADS) {
      const int t = i / NMAX, n = i % NMAX;
      const bool ok = t < len && n < N;
      const size_t off = (size_t)(c0 + t) * N + n;
      cs[i] = ok ? cg[off] : 0.f;
      bs[t * BSTRIDE + n] = ok ? bg[off] : 0.f;
    }
    for (int i = tid; i < LMAX * PT; i += THREADS) {
      const int t = i / PT, p = i % PT;
      xs[i] = (t < len && p0 + p < P) ? xg[(size_t)(c0 + t) * P + p0 + p]
                                      : 0.f;
    }
    if (tid < LMAX) sa[tid] = tid < len ? dta[c0 + tid] : 0.f;
    __syncthreads();

    // -- s = cumsum(dta): warp 0, four consecutive rows per lane ----------
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += sa[4 * tid + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) sa[4 * tid + k] = excl + v[k];
    }
    __syncthreads();
    const float s_last = sa[len - 1];
    if (tid < LMAX) {
      es[tid] = expf(sa[tid]);
      wv[tid] = tid < len ? expf(s_last - sa[tid]) : 0.f;
    }

    // -- C.B^T (8x8 per thread), kept in registers -------------------------
    float cb[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cb[i][j] = 0.f;
    for (int n = 0; n < n4; n += 4) {
      float4 ca[8], ba[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ca[i] = ld4(cs + (ty + 16 * i) * NMAX + n);
#pragma unroll
      for (int j = 0; j < 8; ++j) ba[j] = ld4(bs + (tx + 16 * j) * BSTRIDE + n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cb[i][j] = fmaf(ca[i].x, ba[j].x, cb[i][j]);
          cb[i][j] = fmaf(ca[i].y, ba[j].y, cb[i][j]);
          cb[i][j] = fmaf(ca[i].z, ba[j].z, cb[i][j]);
          cb[i][j] = fmaf(ca[i].w, ba[j].w, cb[i][j]);
        }
    }

    // -- C.state (inter-chunk), before the state moves on -----------------
    float yi[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) yi[i][k] = 0.f;
    for (int n = 0; n < n4; n += 4) {
      float4 ca[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ca[i] = ld4(cs + (ty + 16 * i) * NMAX + n);
      const float4 s0 = ld4(st + (n + 0) * PT + 4 * tx);
      const float4 s1 = ld4(st + (n + 1) * PT + 4 * tx);
      const float4 s2 = ld4(st + (n + 2) * PT + 4 * tx);
      const float4 s3 = ld4(st + (n + 3) * PT + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float cv[4] = {ca[i].x, ca[i].y, ca[i].z, ca[i].w};
        const float4 sv[4] = {s0, s1, s2, s3};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yi[i][0] = fmaf(cv[k], sv[k].x, yi[i][0]);
          yi[i][1] = fmaf(cv[k], sv[k].y, yi[i][1]);
          yi[i][2] = fmaf(cv[k], sv[k].z, yi[i][2]);
          yi[i][3] = fmaf(cv[k], sv[k].w, yi[i][3]);
        }
      }
    }
    __syncthreads();   // C and the old state are read: both may change

    // -- scores into C's tile: only tau <= t < len is formed --------------
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tau = tx + 16 * j;
        float v = 0.f;
        if (tau <= t && t < len) v = cb[i][j] * expf(sa[t] - sa[tau]);
        cs[t * NMAX + tau] = v;
      }
    }

    // -- state = exp(s_last) state + (B . w)^T x, own [8 n x 4 p] ---------
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      for (int tau = 0; tau < len; ++tau) {
        const float w = wv[tau];
        const float4 xv = ld4(xs + tau * PT + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float bw = bs[tau * BSTRIDE + ty + 16 * i] * w;
          acc[i][0] = fmaf(bw, xv.x, acc[i][0]);
          acc[i][1] = fmaf(bw, xv.y, acc[i][1]);
          acc[i][2] = fmaf(bw, xv.z, acc[i][2]);
          acc[i][3] = fmaf(bw, xv.w, acc[i][3]);
        }
      }
      const float decay = expf(s_last);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = st + (ty + 16 * i) * PT + 4 * tx;
        float4 o = ld4(row);
        o.x = decay * o.x + acc[i][0];
        o.y = decay * o.y + acc[i][1];
        o.z = decay * o.z + acc[i][2];
        o.w = decay * o.w + acc[i][3];
        *reinterpret_cast<float4*>(row) = o;
      }
    }
    __syncthreads();   // the scores are complete

    // -- y = scores.x + exp(s_t) C.state ----------------------------------
    float yo[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) yo[i][k] = 0.f;
    for (int tau = 0; tau < len4; tau += 4) {
      float4 sc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i] = ld4(cs + (ty + 16 * i) * NMAX + tau);
      const float4 x0 = ld4(xs + (tau + 0) * PT + 4 * tx);
      const float4 x1 = ld4(xs + (tau + 1) * PT + 4 * tx);
      const float4 x2 = ld4(xs + (tau + 2) * PT + 4 * tx);
      const float4 x3 = ld4(xs + (tau + 3) * PT + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sv[4] = {sc[i].x, sc[i].y, sc[i].z, sc[i].w};
        const float4 xv[4] = {x0, x1, x2, x3};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yo[i][0] = fmaf(sv[k], xv[k].x, yo[i][0]);
          yo[i][1] = fmaf(sv[k], xv[k].y, yo[i][1]);
          yo[i][2] = fmaf(sv[k], xv[k].z, yo[i][2]);
          yo[i][3] = fmaf(sv[k], xv[k].w, yo[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t >= len) continue;
      const float e = es[t];
      float* out = yg + (size_t)(c0 + t) * P + p0 + 4 * tx;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p0 + 4 * tx + k < P) out[k] = yo[i][k] + e * yi[i][k];
    }
  }

  if (a.state_out != nullptr) {
    // each thread writes the state entries it updated itself
    float* so = a.state_out + (size_t)bh * N * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + 4 * tx + k;
        if (p < P) so[(size_t)n * P + p] = st[n * PT + 4 * tx + k];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dta [B,H,S], x [B,H,S,P], b/c [B,G,S,N] float32 → y [B,H,S,P] float32 and,
// when state_out is not null, the final state [B,H,N,P] float32.
// Requires 1 <= chunk <= 128, N <= 128, H % G == 0.
int ssd_scan_launch(const void* dta, const void* x, const void* b,
                    const void* c, void* y, void* state_out, int B, int H,
                    int G, int S, int N, int P, int chunk,
                    cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (chunk < 1 || chunk > LMAX || N > NMAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)dta, (const float*)x, (const float*)b,
         (const float*)c,   (float*)y,       (float*)state_out,
         H, G, S, N, P, chunk};
  dim3 grid((unsigned)(B * H), (unsigned)((P + PT - 1) / PT));
  ssd_scan_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
