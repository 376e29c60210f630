// Bit-exact int32 arithmetic of the reference's integer pipeline, shared by
// the int8 kernels (int8_gemm.cu, ita_attention.cu, int_softmax.cu).
//
// add32 / mul32 wrap as int32 does in the reference; shl32 / sra32 follow
// XLA's shift rules (a count past the width gives 0 or the sign);
// round_shift and requantize are core/quant.py's; exp2_fixed is
// core/ita.py's Q8 exponent. build.py hashes this file into every kernel
// library's name, so an edit here rebuilds all three.

#pragma once

namespace int32_ref {

constexpr int FB = 8;                      // Q(FB) exponent domain
constexpr int ONE = 1 << FB;
constexpr int NEG_T = -(31 << FB);         // exponent floor, 2^-31

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
__device__ inline int round_shift(int v, int s) {
  if (s > 0) {
    int half = shl32(1, s - 1);
    return sra32(add32(v, mul32(v >= 0 ? 1 : -1, half)), s);
  }
  if (s == 0) return v;
  return shl32(v, -s);
}

// core/quant.py requantize. Only the lane the reference keeps is computed;
// acc*m of a large acc (which overflows int32) is never formed.
__device__ inline int requantize(int acc, int m, int shift) {
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

// round_shift and requantize without branches: each case is computed and
// one is selected, as core/quant.py does with torch.where. The same
// function; a loop unrolled over several outputs then keeps them all in
// flight instead of serialising them on the branches (B3's epilogue).
__device__ __forceinline__ int round_shift_sel(int v, int s) {
  const int pos = max(s, 1);
  const int half = shl32(1, pos - 1);
  const int rounded = sra32(add32(v, mul32(v >= 0 ? 1 : -1, half)), pos);
  const int left = shl32(v, max(-s, 0));
  return s > 0 ? rounded : (s == 0 ? v : left);
}

__device__ __forceinline__ int requantize_sel(int acc, int m, int shift) {
  const int a = abs32(acc);
  const int y_small = round_shift_sel(mul32(acc, m), shift);
  const int bits = __float_as_int((float)a);
  const int pre = max(((bits >> 23) & 0xFF) - 126 - 15, 0);
  const int y_big = shift - pre < 0
                        ? (acc >= 0 ? 127 : -127)
                        : round_shift_sel(mul32(round_shift_sel(acc, pre), m),
                                          shift - pre);
  const int y = a < (1 << 16) ? y_small : y_big;
  return min(max(y, -127), 127);
}

// core/ita.py exp2_fixed: 2^(t / 256) in Q8 for t <= 0
__device__ __forceinline__ int exp2_fixed(int t) {
  int ip = t >> FB;                        // arithmetic shift: floor
  int fp = t - ip * ONE;
  return (ONE + fp) >> min(max(-ip, 0), 31);
}

}  // namespace int32_ref
