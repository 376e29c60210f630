// Paged attention over a block pool, for sm_90a: one-token decode and the
// small-q speculative verify step.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py
//   * paged_attention_pallas (body _paged_kernel) — float pools (bf16/f32);
//   * paged_attention_int8_pallas (body _paged_int8_kernel) — int8 pools
//     with per-block scales: q requantized by Q_SCALE (round half even),
//     exact int32 q8·k8 score dots scaled by q_scale·k_scale[block], the V
//     scale folded into each block's partial product;
//   * paged_attention_verify_pallas (body _paged_verify_kernel) and
//     paged_attention_verify_int8_pallas (_paged_verify_int8_kernel) — the
//     same two over Q = spec_tokens + 1 query rows per batch row, folded
//     into the GQA group axis (row g·Q + j is query j of head g) with row
//     j attending lens + j keys.
// Contract: allclose with repro_torch/kernels/paged_attention/ref.py
//   (paged_attention_ref, paged_attention_int8_dequant_ref and their
//   verify versions): the online softmax only reorders f32 additions.
//   Length mask, optional sliding window, per-row start offset; rows with
//   lens == 0 write zeros.
//
// What bounds it: decode reads each row's live K/V blocks once — bytes,
//   not operations (a GQA group of G query heads does 2·G flops per K/V
//   element, verify 2·G·Q). At serving sizes the whole call moves a few
//   MB, so a naive kernel is latency-bound long before it reaches the
//   card's memory rate.
// What the design does about it: one block per (row, kv head, row chunk)
//   holds up to `rows` folded query rows of the GQA group (all 16 query
//   heads of glm4-9b's decode in one chunk), so every pool block is read
//   once per kv head and chunk, not once per query head. The block walks
//   its table entries in order — the loop replaces the TPU's sequential
//   grid axis — starting at the first entry inside the window and stopping
//   at the first entry past the longest row's length (lens + Q - 1); K/V
//   of one entry are staged in shared memory (K rows padded against bank
//   conflicts) and the running max, sum and accumulator stay in shared
//   memory and registers. Splitting long rows over several blocks
//   (flash-decoding) and cp.async/TMA staging are later work.
// Verify: the accumulators live in registers, at most 16 per thread of
//   256 (rows·D ≤ 4096), and glm4-9b's verify at k = 4 has G·Q = 80 rows
//   of 128 = 10240. So the G·Q folded rows are split over a third grid
//   axis in balanced chunks (80 → 3 × ≤ 27 rows); each chunk re-reads the
//   entry's K/V, mostly from L2. This keeps one kernel body for decode
//   and verify: the per-row arithmetic (dot order, one warp per row's
//   softmax with lane = key, the accumulate order) does not depend on Q,
//   the chunk or the row's position in it, and a row's masked entries
//   (score −inf → p = 0, alpha = 1, or alpha = 0 while nothing is valid
//   yet) leave its state bit for bit as it was. So verify at Q = 1 is
//   decode bit for bit, and row 0 at any Q equals decode at the same lens.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_PER_THREAD = 16;   // accumulators per thread: rows·D ≤ 4096

struct Params {
  const void* q;        // [B, Hq, Q, D] f32 | bf16
  const void* k;        // [N, Hkv, blk, D] f32 | bf16 | int8
  const void* v;
  const int* table;     // [B, M]
  const int* lens;      // [B]
  const int* start;     // [B] or null (zeros)
  const float* kscale;  // [N] (int8 pools)
  const float* vscale;  // [N]
  void* out;            // [B, Hq, Q, D], q's dtype
  int B, Hq, Hkv, D, N, blk, M, window;  // window < 0: none
  int Q;                // query rows per batch row (1: decode)
  int rows;             // folded rows per block (blockIdx.z = chunk)
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

// Shared-memory plan (bytes) for G folded query rows:
// q | K (padded rows) | V | scores | m, l, alpha
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
  const int D = p.D, blk = p.blk, Q = p.Q;
  const int R = (p.Hq / p.Hkv) * Q;            // folded rows of the group
  const int r0 = blockIdx.z * p.rows;          // this chunk's first row
  const int G = min(p.rows, R - r0);           // rows of this chunk
  const int GD = G * D;
  const Layout L = make_layout(p.rows, D, blk, INT8);
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

  // folded row r of kv head h is query r % Q of head h·(Hq/Hkv) + r / Q;
  // in [B, Hq, Q, D] the group's R rows are contiguous
  const size_t row_base = ((size_t)b * p.Hq * Q + (size_t)h * R + r0) * D;
  const QT* qp = static_cast<const QT*>(p.q) + row_base;
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

  // table entries that hold a position in [max(start, lens - window),
  // lens + Q - 1): row 0's window starts first, the last row ends last
  const int len_max = len + Q - 1;
  const int n_ent = len_max > st ? min(p.M, (len_max - st + blk - 1) / blk) : 0;
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
      const int len_g = len + (r0 + g) % Q;  // this row's effective length
      const bool valid = pos < len_g && (p.window < 0 || pos >= len_g - p.window);
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

  QT* op = static_cast<QT*>(p.out) + row_base;
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
  if (G * p.Hkv != p.Hq || p.Q < 1 || p.rows < 1 ||
      p.rows * p.D > MAX_PER_THREAD * THREADS)
    return (int)cudaErrorInvalidValue;
  const int chunks = (G * p.Q + p.rows - 1) / p.rows;
  const Layout L = make_layout(p.rows, p.D, p.blk, INT8);
  auto kernel = paged_attention_kernel<QT, KT, INT8>;
  if (L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.Hkv, p.B, chunks);
  kernel<<<grid, THREADS, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* table, const void* lens, const void* start,
                   const void* kscale, const void* vscale, void* out, int B,
                   int Hq, int Hkv, int D, int N, int blk, int M, int window,
                   int Q, int rows, float rsd, float q_scale, float q_inv) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.table = (const int*)table; p.lens = (const int*)lens;
  p.start = (const int*)start;
  p.kscale = (const float*)kscale; p.vscale = (const float*)vscale;
  p.out = out;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.D = D; p.N = N; p.blk = blk; p.M = M;
  p.window = window; p.Q = Q; p.rows = rows;
  p.rsd = rsd; p.q_scale = q_scale; p.q_inv = q_inv;
  return p;
}

int launch_float(const Params& p, int qtype, int kvtype, cudaStream_t s) {
  if (qtype == 0 && kvtype == 0) return launch_typed<float, float, false>(p, s);
  if (qtype == 0 && kvtype == 1) return launch_typed<float, __nv_bfloat16, false>(p, s);
  if (qtype == 1 && kvtype == 0) return launch_typed<__nv_bfloat16, float, false>(p, s);
  if (qtype == 1 && kvtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, false>(p, s);
  return (int)cudaErrorInvalidValue;
}

int launch_int8(const Params& p, int qtype, int kvtype, cudaStream_t s) {
  if (kvtype != 2 || !p.kscale || !p.vscale) return (int)cudaErrorInvalidValue;
  if (qtype == 0) return launch_typed<float, int8_t, true>(p, s);
  if (qtype == 1) return launch_typed<__nv_bfloat16, int8_t, true>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every entry point takes the same arguments. qtype: 0 f32, 1 bf16;
// kvtype: 0 f32, 1 bf16 (float pools), 2 int8 (with per-block kscale/vscale).
// Q: query rows per batch row; rows: folded rows per block. The decode entry
// points take Q = 1 (B1, B2), the verify ones Q = k + 1 (B4, B5).
#define REPRO_PAGED_ARGS                                                     \
  const void *q, const void *k, const void *v, const void *table,            \
      const void *lens, const void *start, const void *kscale,               \
      const void *vscale, void *out, int qtype, int kvtype, int B, int Hq,   \
      int Hkv, int D, int N, int blk, int M, int window, int Q, int rows,    \
      float rsd, float q_scale, float q_inv, void *stream
#define REPRO_PAGED_PARAMS                                                   \
  make_params(q, k, v, table, lens, start, kscale, vscale, out, B, Hq, Hkv,  \
              D, N, blk, M, window, Q, rows, rsd, q_scale, q_inv)

int paged_attention_launch(REPRO_PAGED_ARGS) {
  if (Q != 1) return (int)cudaErrorInvalidValue;
  return launch_float(REPRO_PAGED_PARAMS, qtype, kvtype, (cudaStream_t)stream);
}

int paged_attention_int8_launch(REPRO_PAGED_ARGS) {
  if (Q != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(REPRO_PAGED_PARAMS, qtype, kvtype, (cudaStream_t)stream);
}

int paged_attention_verify_launch(REPRO_PAGED_ARGS) {
  return launch_float(REPRO_PAGED_PARAMS, qtype, kvtype, (cudaStream_t)stream);
}

int paged_attention_verify_int8_launch(REPRO_PAGED_ARGS) {
  return launch_int8(REPRO_PAGED_PARAMS, qtype, kvtype, (cudaStream_t)stream);
}

}  // extern "C"
