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
//   into an FMA. expf, expm1f and sqrtf are the accurate ones (no fast
//   math). Any S >= 1 (the TPU kernel wants S % 256 == 0).
//
// What bounds it: bytes. Per element it reads log_a (4 B) and u (2 or 4 B)
//   and writes h (2 or 4 B), and does a few flops: at recurrentgemma-9b's
//   D = 4096 and a 512-token prefill (B = 1) that is 16.8 MB in bf16, 5 us
//   at 3.35 TB/s. Only the last multiply-add of a step depends on the step
//   before.
// What the design does about it: one thread per (batch, channel) walks S
//   with h in a register; neighbouring threads own neighbouring channels,
//   so every load and store of a step is coalesced across D. The loads
//   (and the exp/expm1/sqrt that need no h) of the next STEPS rows are
//   issued before the current rows' recurrence runs, so a thread keeps
//   2 x STEPS loads in flight instead of waiting on each step. At B = 1,
//   D = 4096 this is only 32 blocks of 128 threads on 132 SMs; a chunked
//   two-pass scan (chunk-local scans in parallel, then the carries) is the
//   later speed-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STEPS = 16;   // rows prefetched ahead of the recurrence

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_kernel(
    const float* __restrict__ log_a, const T* __restrict__ u,
    T* __restrict__ out, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  const float* la_p = log_a + base;
  const T* u_p = u + base;
  T* o_p = out + base;

  float la[STEPS], uu[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (j < S) {
      la[j] = la_p[(long long)j * D];
      uu[j] = to_f32(u_p[(long long)j * D]);
    }
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += STEPS) {
    // this group's decay and input, then the next group's loads in flight
    float a[STEPS], bu[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (t0 + j < S) {
        a[j] = expf(la[j]);
        bu[j] = __fmul_rn(sqrtf(-expm1f(2.f * la[j])), uu[j]);
      }
    }
    const int t1 = t0 + STEPS;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (t1 + j < S) {
        la[j] = la_p[(long long)(t1 + j) * D];
        uu[j] = to_f32(u_p[(long long)(t1 + j) * D]);
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (t0 + j < S) {
        h = __fadd_rn(__fmul_rn(a[j], h), bu[j]);
        store(o_p + (long long)(t0 + j) * D, h);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// log_a [B,S,D] float32, u [B,S,D] (u_dtype 0: float32, 1: bfloat16) →
// out [B,S,D] in u's dtype. Requires B, S, D >= 1.
int rglru_launch(const void* log_a, const void* u, void* out, int B, int S,
                 int D, int u_dtype, cudaStream_t stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((D + THREADS - 1) / THREADS), (unsigned)B);
  if (u_dtype == 0) {
    rglru_kernel<float><<<grid, THREADS, 0, stream>>>(
        (const float*)log_a, (const float*)u, (float*)out, S, D);
  } else if (u_dtype == 1) {
    rglru_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        (const float*)log_a, (const __nv_bfloat16*)u, (__nv_bfloat16*)out, S,
        D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
