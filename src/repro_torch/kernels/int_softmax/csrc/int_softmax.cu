// ITA integer softmax over int8 logits, for sm_90a.
//
// Replaces: src/repro/kernels/int_softmax/kernel.py int_softmax_pallas (body
//   _softmax_kernel): a grid of row blocks, each row softmaxed in two passes
//   in VMEM.
// Contract: bit-exact with repro_torch/kernels/int_softmax/ref.py
//   int_softmax_ref (core/ita.py int_softmax). Per row of C int8 logits x:
//     m   = max x
//     t   = max(((x - m) * mult) >> rshift, -(31 << 8))   (Q8 exponent)
//     e   = exp2_fixed(t) = (256 + t - (t >> 8) * 256) >> min(-(t >> 8), 31)
//     den = max(sum e, 1)                                  (int32)
//     p   = (e * 255 + (den >> 1)) / den                   (uint8)
//   rshift arrives clipped to [0, 31] (a count outside gives the sign, as
//   XLA's shift does). Any R, and 1 <= C <= 2^22 (e <= 256: the int32 sum
//   holds).
//
// What bounds it: scalar integer operations. It reads C bytes and writes
//   C bytes per row, and the function needs 17 int32 operations per element
//   (max 1, exponent 4, exp2_fixed 8, sum 1, e * 255 + den / 2 and the
//   divide 3), which only the CUDA cores' INT32 lanes do (about 16.75 TOP/s
//   on an H100 SXM). At DINOv2-S's per-layer logits ([6 x 1370, 1370]) that
//   is 191 M operations, 11.4 us, against 22.5 MB, 6.7 us at 3.35 TB/s.
//   The kernel computes the exponent twice (passes 2 and 3) rather than
//   storing it.
// What the design does about it: one warp per row, lanes on neighbouring
//   bytes, so each pass reads the row in coalesced 32-byte pieces; the
//   second and third passes find the row in L1/L2 (1.4 KB at DINOv2-S), so
//   device memory sees each byte about once. Eight rows per block. Rows
//   too long for L1 re-read from L2 or memory: a block per row with the row
//   staged in shared memory is the later speed-up for those.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/int32.cuh"

namespace {

using namespace int32_ref;

constexpr int WARPS = 8;          // rows per block, one warp each
constexpr int PROB_MAX = 255;

__device__ __forceinline__ int exponent(int x, int m, int mult, int rshift) {
  return max(((x - m) * mult) >> rshift, NEG_T);
}

__global__ void __launch_bounds__(WARPS * 32)
int_softmax_kernel(const int8_t* __restrict__ x, uint8_t* __restrict__ out,
                   int R, int C, int mult, int rshift) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const int8_t* xr = x + (size_t)row * C;
  uint8_t* orow = out + (size_t)row * C;

  int m = -128;
  for (int c = lane; c < C; c += 32) m = max(m, (int)xr[c]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));

  int den = 0;
  for (int c = lane; c < C; c += 32)
    den += exp2_fixed(exponent(xr[c], m, mult, rshift));
#pragma unroll
  for (int o = 16; o; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);

  const unsigned d = (unsigned)max(den, 1);
  const unsigned half = d >> 1;
  for (int c = lane; c < C; c += 32) {
    unsigned e = (unsigned)exp2_fixed(exponent(xr[c], m, mult, rshift));
    orow[c] = (uint8_t)((e * PROB_MAX + half) / d);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x [R, C] int8 → out [R, C] uint8. Requires R >= 1, 1 <= C <= 2^22 and
// 0 <= rshift <= 31.
int int_softmax_launch(const void* x, void* out, int R, int C, int mult,
                       int rshift, void* stream) {
  dim3 grid((R + WARPS - 1) / WARPS);
  int_softmax_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (uint8_t*)out, R, C, mult, rshift);
  return (int)cudaGetLastError();
}

}  // extern "C"
