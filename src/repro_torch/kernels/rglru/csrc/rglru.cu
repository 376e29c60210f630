// RG-LRU diagonal recurrence (Griffin / RecurrentGemma), for sm_90a.
//
// Replaces: src/repro/kernels/rglru/kernel.py rglru_pallas (body
//   _rglru_kernel): a grid of (batch, 256-row chunks) that carries the
//   hidden state across the sequential chunk axis in VMEM scratch.
// Contract: allclose with repro_torch/kernels/rglru/ref.py rglru_ref, in
//   float32 for every (batch, channel):
//     a_t = exp(log_a_t),  beta_t = sqrt(-expm1(2 log_a_t)),
//     h_t = a_t h_{t-1} + beta_t u_t,  h_0 = 0,
//   written out in u's dtype (float32 or bfloat16). Each product and sum
//   rounds on its own, as the plain version's separate tensor ops do: the
//   recurrence uses __fmul_rn / __fadd_rn, which the compiler never fuses
//   into an FMA, in the plain version's sequential order, so the result is
//   bit-equal to it wherever expf / expm1f / sqrtf round as PyTorch's do.
//   expf, expm1f and sqrtf are the accurate ones (no fast math). Any
//   S >= 1 (the TPU kernel wants S % 256 == 0).
//
// What bounds it: bytes. Per element it reads log_a (4 B) and u (2 or 4 B)
//   and writes h (2 or 4 B), and does a few flops: at recurrentgemma-9b's
//   D = 4096 and a 512-token prefill (B = 1) that is 16.8 MB in bf16, 5 us
//   at 3.35 TB/s. Only the last multiply-add of a step depends on the step
//   before: about 8 cycles a step, 2.3 us for 512 steps.
// What the design does about it: a block owns C = 16 channels of one
//   batch row (256 blocks at B = 1, D = 4096: two an SM) and walks S in
//   tiles of STEPS rows. Its 8 compute warps stream [STEPS x C] tiles of
//   log_a and u through a STAGES-deep cp.async ring in shared memory
//   (STAGES - 1 tiles, 18 KB a block, in flight),
//   each thread owning the same four channels of one row in every stage,
//   so a thread waits only on its own copies; they compute a_t and
//   beta_t u_t of a whole tile in parallel (the transcendental work, none
//   of which needs h, about 50 float instructions an element: many warps
//   hide its latency) into a double-buffered tile of floats. One serial
//   warp, one lane a channel, meanwhile runs the dependent multiply-add
//   over the previous tile from shared memory (its loads SPAN rows ahead in
//   registers), writing h_t in place of a_t; the compute warps store that
//   tile of h out a tile later, four channels a thread in one store, so no
//   global store sits on the serial path. One __syncthreads a tile hands
//   tiles between the compute warps and the serial warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 16;       // channels a block owns
constexpr int STEPS = 64;   // rows of a staged tile
constexpr int STAGES = 4;   // depth of the cp.async ring
constexpr int GROUP = 4;    // channels a compute thread owns in its row
constexpr int SPAN = 16;    // rows the serial warp loads ahead

template <typename T>
struct Geometry {
  static constexpr int COMPUTE = STEPS * C / GROUP;  // compute threads
  static constexpr int THREADS = COMPUTE + 32;       // + the serial warp
  static constexpr int RAW = STEPS * C * (int)(sizeof(float) + sizeof(T));
  static constexpr int DONE = STEPS * C * 2 * (int)sizeof(float);
  static constexpr int SMEM = STAGES * RAW + 2 * DONE;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// four consecutive outputs in one 16- or 8-byte store
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<unsigned*>(&lo);
  w.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// N-byte copy into shared memory (N = 16, or 8 for four bf16); src_bytes
// = 0 fills it with zeros
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
}

template <typename T>
__global__ void __launch_bounds__(Geometry<T>::THREADS)
rglru_kernel(const float* __restrict__ log_a, const T* __restrict__ u,
             T* __restrict__ out, int S, int D, int vec) {
  using G = Geometry<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_la = reinterpret_cast<float*>(smem);             // [STAGES][STEPS][C]
  T* raw_u = reinterpret_cast<T*>(smem + STAGES * STEPS * C * 4);
  float* dec = reinterpret_cast<float*>(smem + STAGES * G::RAW);  // [2][STEPS][C]
  float* inp = dec + 2 * STEPS * C;                           // [2][STEPS][C]

  const int d0 = blockIdx.x * C;
  const long long base = (long long)blockIdx.y * S * D + d0;
  const int ntiles = (S + STEPS - 1) / STEPS;
  const int tid = threadIdx.x;

  if (tid < G::COMPUTE) {
    // this thread's four channels of row r, the same in every tile
    const int r = tid / (C / GROUP);
    const int c = (tid % (C / GROUP)) * GROUP;
    const bool in_d = d0 + c < D;   // vec: D % 4 == 0, a group is in or out
    auto issue = [&](int tile) {
      if (tile < ntiles) {
        const int t = tile * STEPS + r;
        const bool ok = in_d && t < S;
        // a group past D or S is zero-filled from a valid address
        const long long off = ok ? base + (long long)t * D + c : 0;
        const int st = tile % STAGES;
        float* la_s = raw_la + (st * STEPS + r) * C + c;
        T* u_s = raw_u + (st * STEPS + r) * C + c;
        constexpr int UB = GROUP * (int)sizeof(T);   // u bytes: 8 or 16
        cp_async<16>(la_s, log_a + off, ok ? 16 : 0);
        cp_async<UB>(u_s, u + off, ok ? UB : 0);
      }
      cp_async_commit();   // an empty group past the end keeps the count
    };
    if (vec) {
      for (int tile = 0; tile < STAGES - 1; ++tile) issue(tile);
    }
    for (int k = 0; k <= ntiles + 1; ++k) {
      if (k >= 2) {
        // h of tile k - 2 (the serial warp left it in place of a), out
        // before this buffer takes tile k
        const int t = (k - 2) * STEPS + r;
        const float* h_s = dec + ((k & 1) * STEPS + r) * C + c;
        T* o = out + base + (long long)t * D + c;
        if (vec) {
          if (in_d && t < S) store4(o, *reinterpret_cast<const float4*>(h_s));
        } else {
#pragma unroll
          for (int i = 0; i < GROUP; ++i)
            if (t < S && d0 + c + i < D) store(o + i, h_s[i]);
        }
      }
      if (k < ntiles) {
        float la[GROUP], uu[GROUP];
        const int t = k * STEPS + r;
        if (vec) {
          issue(k + STAGES - 1);  // into the stage this thread read at k - 1
          cp_async_wait_ring();   // this thread's copies of tile k landed
          const int st = k % STAGES;
          const float* la_s = raw_la + (st * STEPS + r) * C + c;
          const T* u_s = raw_u + (st * STEPS + r) * C + c;
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            la[i] = la_s[i];
            uu[i] = to_f32(u_s[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const bool ok = t < S && d0 + c + i < D;
            const long long off = base + (long long)t * D + c + i;
            la[i] = ok ? log_a[off] : 0.f;
            uu[i] = ok ? to_f32(u[off]) : 0.f;
          }
        }
        float a[GROUP], bu[GROUP];
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          a[i] = expf(la[i]);
          bu[i] = __fmul_rn(sqrtf(-expm1f(2.f * la[i])), uu[i]);
        }
        float* a_s = dec + ((k & 1) * STEPS + r) * C + c;
        float* b_s = inp + ((k & 1) * STEPS + r) * C + c;
        *reinterpret_cast<float4*>(a_s) = make_float4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<float4*>(b_s) =
            make_float4(bu[0], bu[1], bu[2], bu[3]);
      }
      __syncthreads();   // tile k computed; the serial warp is done with k - 1
    }
  } else {
    // the serial warp: lane = channel, h in a register
    const int lane = tid - G::COMPUTE;
    float h = 0.f;
    for (int k = 0; k <= ntiles + 1; ++k) {
      if (k >= 1 && k <= ntiles && lane < C) {
        const int j = k - 1;
        const int n = min(STEPS, S - j * STEPS);
        // h_t overwrites a_t in place: the compute warps store it out
        float* a_s = dec + (j & 1) * STEPS * C + lane;
        const float* b_s = inp + (j & 1) * STEPS * C + lane;
        if (n == STEPS) {
          // loads of the next SPAN rows in flight while this span's
          // dependent multiply-adds run (the loads are issued ahead of the
          // stores in program order, so nothing holds them back)
          float a0[SPAN], b0[SPAN];
#pragma unroll
          for (int i = 0; i < SPAN; ++i) {
            a0[i] = a_s[i * C];
            b0[i] = b_s[i * C];
          }
#pragma unroll
          for (int c = 0; c < STEPS; c += SPAN) {
            float a1[SPAN], b1[SPAN];
            if (c + SPAN < STEPS) {
#pragma unroll
              for (int i = 0; i < SPAN; ++i) {
                a1[i] = a_s[(c + SPAN + i) * C];
                b1[i] = b_s[(c + SPAN + i) * C];
              }
            }
#pragma unroll
            for (int i = 0; i < SPAN; ++i) {
              h = __fadd_rn(__fmul_rn(a0[i], h), b0[i]);
              a_s[(c + i) * C] = h;
            }
            if (c + SPAN < STEPS) {
#pragma unroll
              for (int i = 0; i < SPAN; ++i) {
                a0[i] = a1[i];
                b0[i] = b1[i];
              }
            }
          }
        } else {
          for (int t = 0; t < n; ++t) {
            h = __fadd_rn(__fmul_rn(a_s[t * C], h), b_s[t * C]);
            a_s[t * C] = h;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch(const float* log_a, const T* u, T* out, int B, int S,
                   int D, cudaStream_t stream) {
  using G = Geometry<T>;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        rglru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // staging needs whole groups of four channels at aligned rows
  const int vec = D % GROUP == 0 &&
                  ((uintptr_t)log_a | (uintptr_t)u | (uintptr_t)out) % 16 == 0;
  dim3 grid((unsigned)((D + C - 1) / C), (unsigned)B);
  rglru_kernel<T><<<grid, G::THREADS, G::SMEM, stream>>>(log_a, u, out,
                                                            S, D, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// log_a [B,S,D] float32, u [B,S,D] (u_dtype 0: float32, 1: bfloat16) →
// out [B,S,D] in u's dtype. Requires B, S, D >= 1 and B <= 65535.
int rglru_launch(const void* log_a, const void* u, void* out, int B, int S,
                 int D, int u_dtype, cudaStream_t stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (u_dtype == 0)
    return (int)launch<float>((const float*)log_a, (const float*)u,
                              (float*)out, B, S, D, stream);
  if (u_dtype == 1)
    return (int)launch<__nv_bfloat16>((const float*)log_a,
                                      (const __nv_bfloat16*)u,
                                      (__nv_bfloat16*)out, B, S, D, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
