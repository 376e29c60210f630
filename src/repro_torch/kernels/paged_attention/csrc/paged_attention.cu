// Paged one-token decode attention over a block pool, for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py
//   * paged_attention_pallas (body _paged_kernel) — float pools (bf16/f32);
//   * paged_attention_int8_pallas (body _paged_int8_kernel) — int8 pools
//     with per-block scales: q requantized by Q_SCALE (round half even),
//     exact int32 q8·k8 score dots scaled by q_scale·k_scale[block], the V
//     scale folded into each block's partial product.
// Contract: allclose with repro_torch/kernels/paged_attention/ref.py
//   (paged_attention_ref, paged_attention_int8_dequant_ref): the online
//   softmax only reorders f32 additions. Length mask, optional sliding
//   window, per-row start offset; rows with lens == 0 write zeros.
//
// What bounds it: decode reads each row's live K/V blocks once — bytes,
//   not operations (a GQA group of G query heads does 2·G flops per K/V
//   element). At serving sizes the whole call moves a few MB, so a naive
//   kernel is latency-bound long before it reaches the card's memory rate.
// What the design does about it: one block per (row, kv head) holds the
//   whole GQA group (16 query heads for glm4-9b), so every pool block is
//   read once per kv head, not once per query head. The block walks its
//   table entries in order — the loop replaces the TPU's sequential grid
//   axis — starting at the first entry inside the window and stopping at
//   the first entry past lens; K/V of one entry are staged in shared memory
//   (K rows padded against bank conflicts) and the running max, sum and
//   accumulator stay in shared memory and registers. Splitting long rows
//   over several blocks (flash-decoding) and cp.async/TMA staging are
//   later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_PER_THREAD = 16;   // accumulators per thread: G·D ≤ 4096

struct Params {
  const void* q;        // [B, Hq, 1, D] f32 | bf16
  const void* k;        // [N, Hkv, blk, D] f32 | bf16 | int8
  const void* v;
  const int* table;     // [B, M]
  const int* lens;      // [B]
  const int* start;     // [B] or null (zeros)
  const float* kscale;  // [N] (int8 pools)
  const float* vscale;  // [N]
  void* out;            // [B, Hq, 1, D], q's dtype
  int B, Hq, Hkv, D, N, blk, M, window;  // window < 0: none
  float rsd;            // float32(D^-0.5)
  float q_scale;        // float32(Q_SCALE)
  float q_inv;          // float32(1) / float32(Q_SCALE)
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared-memory plan (bytes): q | K (padded rows) | V | scores | m, l, alpha
struct Layout {
  int kstride, q_off, k_off, v_off, s_off, st_off, bytes;
};
__host__ __device__ inline Layout make_layout(int G, int D, int blk, bool int8) {
  Layout L;
  L.kstride = int8 ? D + 4 : D + 1;   // elements; breaks the D-stride bank clash
  int esz = int8 ? 1 : 4;
  L.q_off = 0;
  L.k_off = align16(L.q_off + G * D * esz);
  L.v_off = align16(L.k_off + blk * L.kstride * esz);
  L.s_off = align16(L.v_off + blk * D * 4);
  L.st_off = align16(L.s_off + G * blk * 4);
  L.bytes = align16(L.st_off + 3 * G * 4);
  return L;
}

template <typename QT, typename KT, bool INT8>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.Hq / p.Hkv, D = p.D, blk = p.blk, GD = G * D;
  const Layout L = make_layout(G, D, blk, INT8);
  float* q_s = reinterpret_cast<float*>(smem + L.q_off);
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem + L.q_off);
  float* k_s = reinterpret_cast<float*>(smem + L.k_off);
  int8_t* k8_s = reinterpret_cast<int8_t*>(smem + L.k_off);
  float* v_s = reinterpret_cast<float*>(smem + L.v_off);
  float* s_s = reinterpret_cast<float*>(smem + L.s_off);
  float* m_s = reinterpret_cast<float*>(smem + L.st_off);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = p.lens[b];
  const int st = p.start ? p.start[b] : 0;

  // this block's query rows are heads h·G .. h·G+G-1 of row b
  const QT* qp = static_cast<const QT*>(p.q) + ((size_t)b * p.Hq + (size_t)h * G) * D;
  for (int e = tid; e < GD; e += THREADS) {
    const float qs = to_f(qp[e]) * p.rsd;
    if constexpr (INT8) {
      q8_s[e] = (int8_t)fminf(fmaxf(rintf(qs * p.q_inv), -127.f), 127.f);
    } else {
      q_s[e] = qs;
    }
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[MAX_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_PER_THREAD; ++r) acc[r] = 0.f;

  // table entries that hold a position in [max(start, lens - window), lens)
  const int n_ent = len > st ? min(p.M, (len - st + blk - 1) / blk) : 0;
  int first = 0;
  if (p.window >= 0 && len - p.window > st) first = (len - p.window - st) / blk;

  for (int i = first; i < n_ent; ++i) {
    const int row0 = st + i * blk;
    const int bid = p.table[(size_t)b * p.M + i];
    __syncthreads();  // the previous entry's readers are done with smem
    const size_t base = ((size_t)bid * p.Hkv + h) * (size_t)blk * D;
    const KT* kp = static_cast<const KT*>(p.k) + base;
    const KT* vp = static_cast<const KT*>(p.v) + base;
    for (int e = tid; e < blk * D; e += THREADS) {
      const int j = e / D, d = e - j * D;
      if constexpr (INT8) {
        k8_s[j * L.kstride + d] = (int8_t)kp[e];
      } else {
        k_s[j * L.kstride + d] = to_f(kp[e]);
      }
      v_s[e] = to_f(vp[e]);
    }
    __syncthreads();

    // masked scores of the group against this entry's keys
    const float kscale = INT8 ? p.q_scale * p.kscale[bid] : 0.f;
    for (int e = tid; e < G * blk; e += THREADS) {
      const int g = e / blk, j = e - g * blk, pos = row0 + j;
      const bool valid = pos < len && (p.window < 0 || pos >= len - p.window);
      float sc = -INFINITY;
      if (valid) {
        if constexpr (INT8) {
          int dot = 0;  // exact integer score
          for (int d = 0; d < D; ++d)
            dot += (int)q8_s[g * D + d] * (int)k8_s[j * L.kstride + d];
          sc = (float)dot * kscale;
        } else {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[j * L.kstride + d];
          sc = dot;
        }
      }
      s_s[e] = sc;
    }
    __syncthreads();

    // online softmax: one warp per query row of the group
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, s_s[g * blk + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < blk; j += 32) {
        const float sv = s_s[g * blk + j];
        const float pv = sv == -INFINITY ? 0.f : expf(sv - m_new);
        s_s[g * blk + j] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + (p · v)·v_scale
    const float vscale = INT8 ? p.vscale[bid] : 1.f;
#pragma unroll
    for (int r = 0; r < MAX_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < GD) {
        const int g = e / D, d = e - g * D;
        float pv = 0.f;
        for (int j = 0; j < blk; ++j) pv += s_s[g * blk + j] * v_s[j * D + d];
        if (INT8) pv *= vscale;
        acc[r] = acc[r] * a_s[g] + pv;
      }
    }
  }
  __syncthreads();

  QT* op = static_cast<QT*>(p.out) + ((size_t)b * p.Hq + (size_t)h * G) * D;
#pragma unroll
  for (int r = 0; r < MAX_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    if (e < GD) {
      const float l = l_s[e / D];
      op[e] = from_f<QT>(l == 0.f ? 0.f : acc[r] / l);  // lens == 0 → zeros
    }
  }
}

template <typename QT, typename KT, bool INT8>
int launch_typed(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  if (G * p.Hkv != p.Hq || G * p.D > MAX_PER_THREAD * THREADS)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(G, p.D, p.blk, INT8);
  auto kernel = paged_attention_kernel<QT, KT, INT8>;
  if (L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.Hkv, p.B);
  kernel<<<grid, THREADS, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* table, const void* lens, const void* start,
                   const void* kscale, const void* vscale, void* out, int B,
                   int Hq, int Hkv, int D, int N, int blk, int M, int window,
                   float rsd, float q_scale, float q_inv) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.table = (const int*)table; p.lens = (const int*)lens;
  p.start = (const int*)start;
  p.kscale = (const float*)kscale; p.vscale = (const float*)vscale;
  p.out = out;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.D = D; p.N = N; p.blk = blk; p.M = M;
  p.window = window; p.rsd = rsd; p.q_scale = q_scale; p.q_inv = q_inv;
  return p;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// qtype: 0 f32, 1 bf16; kvtype: 0 f32, 1 bf16 (float pools)
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* table, const void* lens,
                           const void* start, const void* kscale,
                           const void* vscale, void* out, int qtype,
                           int kvtype, int B, int Hq, int Hkv, int D, int N,
                           int blk, int M, int window, float rsd,
                           float q_scale, float q_inv, void* stream) {
  Params p = make_params(q, k, v, table, lens, start, kscale, vscale, out, B,
                         Hq, Hkv, D, N, blk, M, window, rsd, q_scale, q_inv);
  cudaStream_t s = (cudaStream_t)stream;
  if (qtype == 0 && kvtype == 0) return launch_typed<float, float, false>(p, s);
  if (qtype == 0 && kvtype == 1) return launch_typed<float, __nv_bfloat16, false>(p, s);
  if (qtype == 1 && kvtype == 0) return launch_typed<__nv_bfloat16, float, false>(p, s);
  if (qtype == 1 && kvtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, false>(p, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pools (kvtype 2) with per-block kscale/vscale
int paged_attention_int8_launch(const void* q, const void* k, const void* v,
                                const void* table, const void* lens,
                                const void* start, const void* kscale,
                                const void* vscale, void* out, int qtype,
                                int kvtype, int B, int Hq, int Hkv, int D,
                                int N, int blk, int M, int window, float rsd,
                                float q_scale, float q_inv, void* stream) {
  Params p = make_params(q, k, v, table, lens, start, kscale, vscale, out, B,
                         Hq, Hkv, D, N, blk, M, window, rsd, q_scale, q_inv);
  cudaStream_t s = (cudaStream_t)stream;
  if (kvtype != 2 || !kscale || !vscale) return (int)cudaErrorInvalidValue;
  if (qtype == 0) return launch_typed<float, int8_t, true>(p, s);
  if (qtype == 1) return launch_typed<__nv_bfloat16, int8_t, true>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
