// ITA fused int8 attention with an integer streaming softmax, for sm_90a.
//
// Replaces: src/repro/kernels/ita_attention/kernel.py ita_attention_pallas
//   (body _attn_kernel): a grid of (batch*head, q tile, kv tile) whose
//   innermost kv axis carries acc/den/be in VMEM scratch, with causal tiles
//   above the diagonal skipped.
// Contract: bit-exact with repro_torch/kernels/ita_attention/ref.py
//   ita_attention_ref. Per query row, for each kv tile of bkv keys in order:
//     s32 = q . k                               exact int32 (dp4a)
//     s8  = requantize(s32, qk_mult, qk_shift)  core/quant.py, int32 only
//     t   = max((s8 * alpha_mult) >> alpha_rshift, NEG_T), NEG_T above the
//           diagonal when causal
//     be' = max(be, ceil(max t / 256)),  sh = min(be' - be, 31)
//     p8  = min(exp2_fixed(max(t - be' * 256, NEG_T)) >> 1, 127)
//     acc = (acc >> sh) + p8 . V,  den = (den >> sh) + sum p8
//   and out = clip(round_half_away(f32(acc) / f32(max(den, 1)) * out_mult)).
//   be starts at -31. When causal, row r folds tile ki in only if
//   ki * bkv <= (r / bq) * bq + bq - 1: the TPU kernel's skip of the tiles
//   wholly above the diagonal of a q tile of bq rows, applied per logical q
//   tile (not per block of this kernel), so the result does not depend on
//   the launch geometry. The epilogue rounds each step on its own
//   (__fdiv_rn, __fmul_rn, __fadd_rn: no FMA contraction), as the plain
//   version's separate tensor ops do. GQA: q head h reads kv head
//   h / group in place.
//
// What bounds it: operations. Per (row, key) pair the mask keeps, the two
//   products take 4 * D int8 operations (tensor-core work), and the integer
//   softmax 26 scalar int32 operations on the CUDA cores (requantize 9,
//   alpha 3, tile max 1, exponent 2, exp2_fixed 8, p8 2, sum 1). At
//   glm4-9b's prefill width (32 q heads, S = 2048, D = 128, causal: 67.1 M
//   pairs) that is 34.4 G int8 operations, 17.4 us at 1979 TOP/s, and
//   1.75 G int32 operations, 104 us at about 16.75 TOP/s: the scalar
//   softmax bounds it, against 17.8 MB of q, k, v and out (5.3 us at
//   3.35 TB/s).
// What the design does about it: nothing fast yet; it is the simple kernel
//   that is right. A block of 8 warps owns 16 query rows of one head (two
//   per warp) and walks the kv tiles in the reference's order (a split over
//   kv would change the shift-rescaled sums). Each tile's K (row-major) and
//   V (transposed, keys packed four to a word) are staged in shared memory,
//   row strides odd in words so lanes on neighbouring keys or columns hit
//   distinct banks, and shared by the block's 16 rows. A lane computes the
//   scores of keys lane, lane + 32, ... with __dp4a over 4-byte words, the
//   warp reduces the tile maximum and the probability sum with shuffles,
//   and each lane then owns output columns lane, lane + 32, ... with its
//   int32 acc in registers (__dp4a over four keys at a time). Tensor-core
//   int8 MMA (wgmma), TMA staging and more rows per block are the later
//   speed-up.
// Limits: bkv <= 256, D <= 256 (any D: rows are zero-padded to words).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/int32.cuh"

namespace {

using namespace int32_ref;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 2;                  // query rows per warp
constexpr int ROWS = WARPS * RPW;       // query rows per block
constexpr int MAX_BKV = 256;
constexpr int MAX_D = 256;
constexpr int KPL = MAX_BKV / 32;       // keys per lane
constexpr int DPL = MAX_D / 32;         // output columns per lane

struct Layout {
  int dw, sk, bw, sv;                      // words: q/k row, K stride, V^T row, V^T stride
  __host__ __device__ Layout(int d, int bkv)
      : dw((d + 3) / 4), sk(((d + 3) / 4) | 1), bw((bkv + 3) / 4),
        sv(((bkv + 3) / 4) | 1) {}
  __host__ __device__ int words(int d, int bkv) const {
    return bkv * sk + d * sv + ROWS * dw + WARPS * bw;
  }
};

// Stage one kv tile: K row-major (zero-padded to words), V transposed with
// four keys to a word.
template <bool VEC>
__device__ void load_tile(const int8_t* __restrict__ kg,
                          const int8_t* __restrict__ vg, int* kw, int* vt,
                          int d, int bkv, const Layout& L) {
  int8_t* kb = reinterpret_cast<int8_t*>(kw);
  int8_t* vb = reinterpret_cast<int8_t*>(vt);
  if (VEC) {                               // d % 4 == 0: 4-byte words
    const int* k4 = reinterpret_cast<const int*>(kg);
    const int* v4 = reinterpret_cast<const int*>(vg);
    for (int i = threadIdx.x; i < bkv * L.dw; i += THREADS) {
      const int j = i / L.dw, w = i - j * L.dw;
      kw[j * L.sk + w] = __ldg(k4 + i);
      const int word = __ldg(v4 + i);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        vb[(4 * w + b) * L.sv * 4 + j] = (int8_t)(word >> (8 * b));
    }
  } else {
    for (int i = threadIdx.x; i < bkv * L.dw * 4; i += THREADS) {
      const int j = i / (L.dw * 4), c = i - j * L.dw * 4;
      kb[j * L.sk * 4 + c] = c < d ? kg[j * d + c] : (int8_t)0;
    }
    for (int i = threadIdx.x; i < bkv * d; i += THREADS) {
      const int j = i / d, c = i - j * d;
      vb[c * L.sv * 4 + j] = vg[i];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ita_attention_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, int8_t* __restrict__ out,
                     int group, int sq, int skv, int d, int bq, int bkv,
                     int causal, int qk_mult, int qk_shift, int am, int ar,
                     float out_mult) {
  extern __shared__ int smem[];
  const Layout L(d, bkv);
  int* kw = smem;                          // [bkv][sk]
  int* vt = kw + bkv * L.sk;               // [d][sv]
  int* qw = vt + d * L.sv;                 // [ROWS][dw]
  int* pb = qw + ROWS * L.dw;              // [WARPS][bw]

  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t kv_off = (size_t)(bh / group) * skv * d;

  // zero V^T and the probability rows once: their pads past bkv keys must
  // hold 0 (the tile loads never write there)
  for (int i = threadIdx.x; i < d * L.sv + ROWS * L.dw + WARPS * L.bw;
       i += THREADS)
    vt[i] = 0;
  __syncthreads();
  int8_t* qb = reinterpret_cast<int8_t*>(qw);
  for (int i = threadIdx.x; i < ROWS * d; i += THREADS) {
    const int rl = i / d, c = i - rl * d;
    if (row0 + rl < sq)
      qb[rl * L.dw * 4 + c] = q[((size_t)bh * sq + row0 + rl) * d + c];
  }

  int acc[RPW][DPL];
  int den[RPW], be[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    den[r] = 0;
    be[r] = -31;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0;
  }

  const int last = min(row0 + ROWS, sq) - 1;
  const int lim = causal ? (last / bq) * bq + bq - 1 : INT_MAX;
  const int nkv = skv / bkv;
  for (int ki = 0; ki < nkv; ++ki) {
    const int c0 = ki * bkv;
    if (c0 > lim) break;                   // no row of the block needs it
    __syncthreads();                       // the previous tile is consumed
    load_tile<VEC>(k + kv_off + (size_t)c0 * d, v + kv_off + (size_t)c0 * d,
                   kw, vt, d, bkv, L);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int rl = r * WARPS + warp;
      const int row = row0 + rl;
      if (row >= sq) continue;                               // warp-uniform
      if (causal && c0 > (row / bq) * bq + bq - 1) continue;  // tile skipped
      const int* qr = qw + rl * L.dw;
      int tl[KPL];
      int tmax = NEG_T;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int kk = lane + 32 * i;
        tl[i] = NEG_T;
        if (kk < bkv) {
          const int* kr = kw + kk * L.sk;
          int s = 0;
          for (int w = 0; w < L.dw; ++w) s = __dp4a(qr[w], kr[w], s);
          int t = max((requantize(s, qk_mult, qk_shift) * am) >> ar, NEG_T);
          if (causal && c0 + kk > row) t = NEG_T;
          tl[i] = t;
          tmax = max(tmax, t);
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        tmax = max(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const int be_new = max(be[r], -((-tmax) >> FB));
      const int sh = min(max(be_new - be[r], 0), 31);
      int8_t* pw8 = reinterpret_cast<int8_t*>(pb + warp * L.bw);
      int psum = 0;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int kk = lane + 32 * i;
        if (kk < bkv) {
          const int e = exp2_fixed(max(tl[i] - be_new * ONE, NEG_T));
          const int p = min(e >> 1, 127);
          pw8[kk] = (int8_t)p;
          psum += p;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      den[r] = (den[r] >> sh) + psum;
      be[r] = be_new;
      __syncwarp();
      const int* pw = pb + warp * L.bw;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int col = lane + 32 * c;
        if (col < d) {
          const int* vr = vt + col * L.sv;
          int a = 0;
          for (int w = 0; w < L.bw; ++w) a = __dp4a(pw[w], vr[w], a);
          acc[r][c] = (acc[r][c] >> sh) + a;
        }
      }
      __syncwarp();                        // pw is rewritten by the next row
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r * WARPS + warp;
    if (row >= sq) continue;
    const float dn = __int2float_rn(max(den[r], 1));
    int8_t* orow = out + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        float y = __fmul_rn(__fdiv_rn(__int2float_rn(acc[r][c]), dn),
                            out_mult);
        y = truncf(__fadd_rn(y, y >= 0.f ? 0.5f : -0.5f));
        orow[col] = (int8_t)(int)fminf(fmaxf(y, -127.f), 127.f);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const int8_t* q, const int8_t* k, const int8_t* v,
                   int8_t* out, int nbh, int group, int sq, int skv, int d,
                   int bq, int bkv, int causal, int qk_mult, int qk_shift,
                   int am, int ar, float out_mult, cudaStream_t stream) {
  const size_t bytes = sizeof(int) * (size_t)Layout(d, bkv).words(d, bkv);
  static size_t opted_in = 48 << 10;       // the default dynamic limit
  if (bytes > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ita_attention_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = bytes;
  }
  dim3 grid(nbh, (sq + ROWS - 1) / ROWS);
  ita_attention_kernel<VEC><<<grid, THREADS, bytes, stream>>>(
      q, k, v, out, group, sq, skv, d, bq, bkv, causal, qk_mult, qk_shift,
      am, ar, out_mult);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [nbh, sq, d], k/v [nbh / group, skv, d] int8 → out [nbh, sq, d] int8.
// Requires bq | sq, bkv | skv, 1 <= bkv <= 256, 1 <= d <= 256 and
// 0 <= ar <= 31; q head i reads kv head i / group.
int ita_attention_launch(const void* q, const void* k, const void* v,
                         void* out, int nbh, int group, int sq, int skv,
                         int d, int bq, int bkv, int causal, int qk_mult,
                         int qk_shift, int am, int ar, float out_mult,
                         void* stream) {
  // whole-word tile loads need rows of whole words at aligned addresses
  const bool vec = d % 4 == 0 && ((uintptr_t)k | (uintptr_t)v) % 4 == 0;
  if (vec)
    return (int)launch<true>((const int8_t*)q, (const int8_t*)k,
                             (const int8_t*)v, (int8_t*)out, nbh, group, sq,
                             skv, d, bq, bkv, causal, qk_mult, qk_shift, am,
                             ar, out_mult, (cudaStream_t)stream);
  return (int)launch<false>((const int8_t*)q, (const int8_t*)k,
                            (const int8_t*)v, (int8_t*)out, nbh, group, sq,
                            skv, d, bq, bkv, causal, qk_mult, qk_shift, am,
                            ar, out_mult, (cudaStream_t)stream);
}

}  // extern "C"
