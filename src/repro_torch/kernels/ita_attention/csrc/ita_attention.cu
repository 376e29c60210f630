// ITA fused int8 attention with an integer streaming softmax, for sm_90a.
//
// Replaces: src/repro/kernels/ita_attention/kernel.py ita_attention_pallas
//   (body _attn_kernel): a grid of (batch*head, q tile, kv tile) whose
//   innermost kv axis carries acc/den/be in VMEM scratch, with causal tiles
//   above the diagonal skipped.
// Contract: bit-exact with repro_torch/kernels/ita_attention/ref.py
//   ita_attention_ref. Per query row, for each kv tile of bkv keys in order:
//     s32 = q . k                               exact int32 (s8 MMA)
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
//   softmax a chain of scalar int32 operations on the CUDA cores; this
//   body spends 20 a pair (requantize 7 and its range test 2, tile max 1,
//   exponent 4, exp2_fixed and p8 5, packing p8 for the product 1: three
//   byte permutes for four pairs; the sum of p8 rides on the P.V product
//   as a column of ones, and the be' / sh / rescale work is per row or per
//   tile), against 26 in the first body (requantize 9, alpha 3, tile max 1,
//   exponent 2, exp2_fixed 8, p8 2, sum 1). At glm4-9b's prefill width (32
//   q heads, S = 2048, D = 128, causal: 67.1 M pairs) that is 34.4 G int8
//   operations, 17.4 us at 1979 TOP/s, and 1.34 G int32 operations, 80 us
//   at about 16.75 TOP/s: the scalar softmax bounds it, against 17.8 MB of
//   q, k, v and out (5.3 us at 3.35 TB/s).
// What the design does about it:
//   - Both products on the tensor cores (mma.sync m16n8k32 s8, exact int32
//     sums in any order). A warp owns 16 query rows; a block of W warps
//     (8 where eight query heads share a kv head, else 4) owns 16W rows
//     that share one kv head: W query heads of a GQA group at the same 16
//     positions where the group allows (glm4-9b: 8 of 16), else fewer
//     heads at more positions, so every staged K/V tile serves 16W rows.
//     The host's plan (ops.py plan) picks W and the heads; blocks holding
//     the last positions (the heaviest when causal) are scheduled first.
//   - K/V tiles arrive by a double-buffered cp.async ring (single-buffered
//     where two stages do not fit, e.g. D = 256 with 256-key tiles). K is
//     row-major, the K-major B operand of the scores as it is (ldmatrix).
//   - The softmax runs on the score fragments in registers: requantize,
//     the tile maximum (within the thread, then across the quad with two
//     shuffles), exp2_fixed and p8. The maximum is taken over s8, not t:
//     t is monotone in s8, so max t = t(max s8), computed once per row.
//     Nothing goes through shared memory between the two products.
//   - P.V: the key order inside a 32-key slice is free (integer sums), so
//     V's keys are laid out in shared memory in the order in which the
//     score fragment's columns sit; the packed p8 registers are then the A
//     operand of P.V directly. V is transposed once per staged tile with
//     4x4 byte transposes (__byte_perm). A row of ones beside V^T makes the
//     MMA sum p8 into den.
//   - acc >> sh and den >> sh act per row on the accumulator fragments,
//     and only when some row of the warp moved its block exponent.
//   - Padding: keys past bkv in a tile padded to 32 get p8 = 0 (and stay
//     out of the maximum); D is zero-padded to 32 (q's pad is zero, so K's
//     pad columns never count). A key masked by causality keeps t = NEG_T
//     and its p8 (127 where the row's logits all sit at the floor).
//   - The kv tiles are folded in the reference's order: the shift-rescaled
//     state is not associative across tilings, so kv is never split.
// Limits: bkv <= 256, D <= 256 (any D; rows are zero-padded).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/int32.cuh"

namespace {

using namespace int32_ref;

constexpr int MAX_WARPS = 8;            // a block: 4 or 8 warps
constexpr int MAX_BKV = 256;
constexpr int MAX_D = 256;
constexpr int SMEM_LIMIT = 232448;      // a block's shared memory on sm_90

// Shared-memory geometry of one launch, in bytes. K and raw V: [stages]
// [kpad][kp]; V^T: [dp + 8][vp] (row dp: ones, for den); Q: [16 warps]
// [kp].
// Pitches are an odd number of 16-byte chunks past a multiple of 128 bytes,
// so the eight rows an ldmatrix reads fall in distinct banks.
struct Geo {
  int kpad, dp, kp, vp, stages, warps;
  __host__ __device__ Geo(int d, int bkv, int st, int w)
      : kpad((bkv + 31) / 32 * 32), dp((d + 31) / 32 * 32), kp(dp + 16),
        vp(kpad + 16), stages(st), warps(w) {}
  __host__ __device__ int k_at(int s) const { return s * kpad * kp; }
  __host__ __device__ int v_at(int s) const { return (stages + s) * kpad * kp; }
  __host__ __device__ int vt_at() const { return 2 * stages * kpad * kp; }
  __host__ __device__ int q_at() const { return vt_at() + (dp + 8) * vp; }
  __host__ __device__ int bytes() const { return q_at() + 16 * warps * kp; }
};

struct Args {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  int8_t* out;
  int group, sq, skv, d, bq, bkv, causal;
  int qk_mult, qk_shift, am, ar;
  float out_mult;
  int hpb, warps, npb, stages, vec;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// c[16x8] += a[16x32] . b[32x8], int8 in, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the low bytes of four values, b0 lowest
__device__ __forceinline__ unsigned pack4(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}
// byte e of w, sign-extended (prmt's sign-replicating selectors)
__device__ __forceinline__ int sext_byte(unsigned w, int e) {
  int r;
  const unsigned sel = 0x8880u + 0x1111u * e;
  asm("prmt.b32 %0, %1, 0, %2;\n" : "=r"(r) : "r"(w), "r"(sel));
  return r;
}
// x >> n for n in [0, 32] (PTX clamps the count: 32 gives 0)
__device__ __forceinline__ int shr_u32(int x, int n) {
  int r;
  asm("shr.u32 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// requantize's lane for |s| < 2^16 with 1 <= shift <= 31 (half =
// 2^(shift - 1)): round_shift(s * m, shift) clipped to +-127
__device__ __forceinline__ int requant_small(int s, int m, int half,
                                             int shift) {
  const int v = mul32(s, m);
  return min(max(add32(v, v >= 0 ? half : -half) >> shift, -127), 127);
}

// Copy `rows` rows of `d` bytes (pitch `d` in global memory) into shared
// memory rows of pitch `pitch`: 16-byte cp.async chunks when vec (d % 16 ==
// 0 and aligned bases), else synchronous bytes. The chunk walk steps each
// thread's (row, chunk) without a division per chunk.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int pitch,
                                           const int8_t* src, int rows,
                                           int d, bool vec) {
  if (vec) {
    const int cpr = d >> 4;
    int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
    const int dr = blockDim.x / cpr, dc = blockDim.x - dr * cpr;
    while (r < rows) {
      cp_async16(dst + r * pitch + 16 * c, src + (size_t)r * d + 16 * c);
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      dst[r * pitch + c] = (unsigned char)src[i];
    }
  }
}

// V^T of a staged tile: row c of vt holds column c of V, the keys of each
// 32-key slice in the order of the P fragment's columns: position 4t + i of
// slice half h holds key 16h + 8(i >> 1) + 2t + (i & 1). Each lane moves a
// 4x4 block of bytes (4 keys x 4 columns) with eight __byte_perm.
__device__ __forceinline__ void transpose_v(const unsigned char* vr,
                                            unsigned char* vt, const Geo& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, h = (lane >> 2) & 1, wl = lane >> 3;
  const int nwb = g.dp >> 4;  // blocks of four 4-byte column words
  const int units = (g.kpad >> 5) * nwb;
  for (int u = warp; u < units; u += g.warps) {
    const int ks = u / nwb, wb = u - ks * nwb;
    const int col = 16 * wb + 4 * wl;
    const unsigned char* s = vr + (32 * ks + 16 * h + 2 * t) * g.kp + col;
    const unsigned r0 = *reinterpret_cast<const unsigned*>(s);
    const unsigned r1 = *reinterpret_cast<const unsigned*>(s + g.kp);
    const unsigned r2 = *reinterpret_cast<const unsigned*>(s + 8 * g.kp);
    const unsigned r3 = *reinterpret_cast<const unsigned*>(s + 9 * g.kp);
    const unsigned lo01 = __byte_perm(r0, r1, 0x5140);
    const unsigned hi01 = __byte_perm(r0, r1, 0x7362);
    const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
    const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
    unsigned char* o = vt + col * g.vp + 32 * ks + 16 * h + 4 * t;
    *reinterpret_cast<unsigned*>(o) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<unsigned*>(o + g.vp) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<unsigned*>(o + 2 * g.vp) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<unsigned*>(o + 3 * g.vp) = __byte_perm(hi01, hi23, 0x7632);
  }
}

// Per-warp state across the kv tiles: two rows a thread (fragment rows g
// and g + 8 of the warp's 16).
template <int DT>
struct RowState {
  int acc[4 * DT][4];  // P.V accumulator fragments, 8 columns each
  int den[4];          // the ones column: den of row g in [0], g + 8 in [2]
  int be[2];
};

// Fold one staged kv tile into a warp's 16 rows. MASK: some pair of the
// tile is masked (causal), padded (past bkv) or some row skips the tile.
template <int KT, int DT, bool MASK>
__device__ __forceinline__ void fold_tile(
    const Args& a, const Geo& g, unsigned k_addr, unsigned vt_addr,
    unsigned den_addr, unsigned q_addr, const unsigned (&qa)[DT][4],
    RowState<DT>& st, int c0, const int (&row)[2], const int (&lim)[2],
    int lane) {
  constexpr int NB = 4 * KT;                // 8-key blocks of a tile, at most
  constexpr bool PACK = KT == 8 || DT == 8;  // s8 four to a register
  constexpr bool QREG = DT < 8;              // q fragments held in registers
  constexpr int CH = DT < 8 ? 4 : 1;         // key blocks scored at once
  const int tig = lane & 3;
  const int nnb = (a.bkv + 7) >> 3;
  const int nks = g.kpad >> 5, nds = g.dp >> 5, ndb = g.dp >> 3;

  // s32 of key blocks 4 * kslice + j0 .. + CH - 1 (CH independent MMA
  // chains; one where D = 256 leaves no registers for more): for key block
  // jj the thread holds (row g: keys 2tig, 2tig+1) in s[jj][0..1], (row
  // g + 8: the same keys) in s[jj][2..3]. Key rows past bkv hold stale
  // bytes; their scores are never used.
  auto scores = [&](int kslice, int j0, int (&s)[CH][4]) {
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0;
    const unsigned addr = k_addr + (32 * kslice + 8 * j0) * g.kp;
#pragma unroll
    for (int ks = 0; ks < DT; ks += 2) {
      if (ks < nds) {
        unsigned q0[4], q1[4];
        if (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            q0[i] = qa[ks][i];
            q1[i] = qa[ks + 1 < DT ? ks + 1 : ks][i];
          }
        } else {
          ldsm_x4(q0[0], q0[1], q0[2], q0[3], q_addr + 32 * ks);
          if (ks + 1 < nds)
            ldsm_x4(q1[0], q1[1], q1[2], q1[3], q_addr + 32 * ks + 32);
        }
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          unsigned b0, b1, b2, b3;
          if (ks + 1 < nds) {
            ldsm_x4(b0, b1, b2, b3, addr + 8 * jj * g.kp + 32 * ks);
            mma_s8(s[jj], q0, b0, b1);
            mma_s8(s[jj], q1, b2, b3);
          } else {
            ldsm_x2(b0, b1, addr + 8 * jj * g.kp + 32 * ks);
            mma_s8(s[jj], q0, b0, b1);
          }
        }
      }
    }
  };
  auto masked = [&](int j, int e) {  // causal mask of pair (j, e)
    return a.causal && c0 + 8 * j + 2 * tig + (e & 1) > row[e >> 1];
  };
  auto padded = [&](int j, int e) { return 8 * j + 2 * tig + (e & 1) >= a.bkv; };

  // pass 1: requantized scores (-128 marks a masked or padded key) and
  // each row's maximum
  int sv[PACK ? 1 : NB][4];
  unsigned svp[PACK ? NB : 1];
  int mx0 = -128, mx1 = -128;
  auto pass1 = [&](auto generic) {
    constexpr bool GEN = decltype(generic)::value;
    const int half = 1 << ((a.qk_shift - 1) & 31);
    bool big = false;
    mx0 = mx1 = -128;
#pragma unroll
    for (int kslice = 0; kslice < KT; ++kslice) {
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += CH) {
       if (kslice < nks) {
        int s[CH][4];
        scores(kslice, j0, s);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          const int j = 4 * kslice + j0 + jj;
          if (j < nnb) {
            int s8[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (GEN) {
                s8[e] = requantize(s[jj][e], a.qk_mult, a.qk_shift);
              } else {
                big |= (unsigned)s[jj][e] + 65535u > 131070u;
                s8[e] = requant_small(s[jj][e], a.qk_mult, half, a.qk_shift);
              }
              if (MASK && (padded(j, e) || masked(j, e))) s8[e] = -128;
            }
            if (PACK) {
              svp[PACK ? j : 0] = pack4(s8[0], s8[1], s8[2], s8[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) sv[PACK ? 0 : j][e] = s8[e];
            }
            mx0 = max(mx0, max(s8[0], s8[1]));
            mx1 = max(mx1, max(s8[2], s8[3]));
          }
        }
       }
      }
    }
    return big;
  };
  const bool small_ok = a.qk_shift >= 1 && a.qk_shift <= 31;
  if (!small_ok || __any_sync(0xffffffffu, pass1(std::false_type{})))
    pass1(std::true_type{});   // some |s32| >= 2^16: requantize's other lane

  // per row: block exponent, shift, and the exponent offsets of pass 2
  int sh[2], bsub[2], lo[2];
  bool act[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int mx = r ? mx1 : mx0;
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const int tmax = mx == -128 ? NEG_T : max((mx * a.am) >> a.ar, NEG_T);
    act[r] = !MASK || !a.causal || c0 <= lim[r];
    const int be_new = act[r] ? max(st.be[r], -((-tmax) >> FB)) : st.be[r];
    sh[r] = min(be_new - st.be[r], 31);
    st.be[r] = be_new;
    bsub[r] = be_new * ONE;
    // max(t - bsub, NEG_T) = max(y - bsub, lo), t = max(y, NEG_T)
    lo[r] = NEG_T - min(bsub[r], 0);
  }
  if (__any_sync(0xffffffffu, (sh[0] | sh[1]) != 0)) {
#pragma unroll
    for (int n = 0; n < 4 * DT; ++n) {
      if (n < ndb) {
        st.acc[n][0] >>= sh[0];
        st.acc[n][1] >>= sh[0];
        st.acc[n][2] >>= sh[1];
        st.acc[n][3] >>= sh[1];
      }
    }
    st.den[0] >>= sh[0];
    st.den[1] >>= sh[0];
    st.den[2] >>= sh[1];
    st.den[3] >>= sh[1];
  }

  // pass 2: p8 of each 32-key slice, packed as the A operand of P.V
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    if (ks < nks) {
      int p[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * ks + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          int pv = 0;
          if (j < nnb) {
            const int s8 = PACK ? sext_byte(svp[PACK ? j : 0], e)
                                : sv[PACK ? 0 : j][e];
            int x = max(((s8 * a.am) >> a.ar) - bsub[r], lo[r]);
            if (MASK && masked(j, e)) x = lo[r];
            // exp2_fixed(x) >> 1 for x in [NEG_T, 0], capped at 127
            pv = min(shr_u32((x & (ONE - 1)) | ONE, 1 - (x >> FB)), 127);
            if (MASK && (padded(j, e) || !act[r])) pv = 0;
          }
          p[jj][e] = pv;
        }
      }
      const unsigned pa[4] = {pack4(p[0][0], p[0][1], p[1][0], p[1][1]),
                              pack4(p[0][2], p[0][3], p[1][2], p[1][3]),
                              pack4(p[2][0], p[2][1], p[3][0], p[3][1]),
                              pack4(p[2][2], p[2][3], p[3][2], p[3][3])};
#pragma unroll
      for (int n = 0; n < 4 * DT; n += 2) {
        if (n < ndb) {
          unsigned b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3, vt_addr + 8 * n * g.vp + 32 * ks);
          mma_s8(st.acc[n], pa, b0, b1);
          mma_s8(st.acc[n + 1], pa, b2, b3);
        }
      }
      unsigned b0, b1;
      ldsm_x2(b0, b1, den_addr + 32 * ks);
      mma_s8(st.den, pa, b0, b1);
    }
  }
}

template <int KT, int DT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ita_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo g(a.d, a.bkv, a.stages, a.warps);
  unsigned char* vt = smem + g.vt_at();
  unsigned char* qs = smem + g.q_at();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wph = a.warps / a.hpb;        // warps a head
  const int ppb = 16 * wph;               // positions a block
  const int gs = a.group / a.hpb;         // head sets a kv head
  const int nhb = gridDim.x / a.npb;
  const int pb = a.npb - 1 - (int)blockIdx.x / nhb;  // last positions first
  const int hb = blockIdx.x - (int)(blockIdx.x / nhb) * nhb;
  const int kvh = hb / gs;                // flat (batch, kv head)
  const int hs = hb - kvh * gs;
  const int p_blk = pb * ppb;
  const size_t kv_off = (size_t)kvh * a.skv * a.d;
  auto q_head = [&](int w) { return kvh * a.group + hs * a.hpb + w / wph; };
  auto q_pos = [&](int w) { return p_blk + 16 * (w % wph); };
  auto lim_of = [&](int r) { return (r / a.bq) * a.bq + a.bq - 1; };

  // q rows (zero past sq and past d) and the ones row of V^T
  for (int i = threadIdx.x; i < 16 * g.warps * (g.dp >> 2);
       i += blockDim.x) {
    const int rr = i / (g.dp >> 2), c = 4 * (i - rr * (g.dp >> 2));
    const int w = rr >> 4, pos = q_pos(w) + (rr & 15);
    unsigned word = 0;
    if (pos < a.sq && c < a.d) {
      const int8_t* src =
          a.q + ((size_t)q_head(w) * a.sq + pos) * a.d + c;
      if (a.vec) {
        word = *reinterpret_cast<const unsigned*>(src);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (c + b < a.d) word |= (unsigned)(uint8_t)src[b] << (8 * b);
      }
    }
    *reinterpret_cast<unsigned*>(qs + rr * g.kp + c) = word;
  }
  for (int i = threadIdx.x; i < 8 * (g.vp >> 2); i += blockDim.x)
    reinterpret_cast<unsigned*>(vt + g.dp * g.vp)[i] =
        i < (g.vp >> 2) ? 0x01010101u : 0u;

  const int pos0 = q_pos(warp);
  const int row[2] = {pos0 + (lane >> 2), pos0 + (lane >> 2) + 8};
  const int lim[2] = {lim_of(row[0]), lim_of(row[1])};
  const bool live = pos0 < a.sq;
  const int wlim = lim_of(min(pos0 + 15, a.sq - 1));
  const int nkv = a.skv / a.bkv;
  const int ntiles = a.causal
      ? min(nkv, lim_of(min(p_blk + ppb, a.sq) - 1) / a.bkv + 1)
      : nkv;
  const bool pad = (a.bkv & 7) != 0;

  // per-lane ldmatrix addresses: K rows (keys), V^T rows (columns), Q rows
  const unsigned k_lane = (lane & 7) * g.kp + 16 * (lane >> 3);
  const unsigned vt_addr =
      smem_u32(vt) + (8 * (lane >> 4) + (lane & 7)) * g.vp + 16 * ((lane >> 3) & 1);
  const unsigned den_addr =
      smem_u32(vt) + (g.dp + (lane & 7)) * g.vp + 16 * ((lane >> 3) & 1);
  const unsigned q_addr = smem_u32(qs) +
      (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * g.kp + 16 * (lane >> 4);

  RowState<DT> st;
#pragma unroll
  for (int n = 0; n < 4 * DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) st.den[e] = 0;
  st.be[0] = st.be[1] = -31;

  auto issue = [&](int tile) {
    const int s = tile % a.stages;
    const size_t off = kv_off + (size_t)tile * a.bkv * a.d;
    stage_rows(smem + g.k_at(s), g.kp, a.k + off, a.bkv, a.d, a.vec);
    stage_rows(smem + g.v_at(s), g.kp, a.v + off, a.bkv, a.d, a.vec);
    cp_async_commit();
  };

  __syncthreads();   // q rows staged
  unsigned qa[DT][4];
#pragma unroll
  for (int ks = 0; ks < DT; ++ks) {
    if (DT < 8 && ks < (g.dp >> 5)) {
      ldsm_x4(qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], q_addr + 32 * ks);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = 0;
    }
  }

  if (a.stages == 2 && ntiles > 0) issue(0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % a.stages;
    if (a.stages == 2) {
      cp_async_wait_all();
      __syncthreads();   // tile i landed; every warp is past tile i - 1
      if (i + 1 < ntiles) issue(i + 1);
    } else {
      __syncthreads();   // every warp is past tile i - 1
      issue(i);
      cp_async_wait_all();
      __syncthreads();
    }
    transpose_v(smem + g.v_at(s), vt, g);
    __syncthreads();
    const int c0 = i * a.bkv;
    if (!live || (a.causal && c0 > wlim)) continue;   // warp-uniform
    const unsigned k_addr = smem_u32(smem + g.k_at(s)) + k_lane;
    if (pad || (a.causal && c0 + a.bkv - 1 > pos0))
      fold_tile<KT, DT, true>(a, g, k_addr, vt_addr, den_addr, q_addr, qa,
                              st, c0, row, lim, lane);
    else
      fold_tile<KT, DT, false>(a, g, k_addr, vt_addr, den_addr, q_addr, qa,
                               st, c0, row, lim, lane);
  }

  // epilogue: den of each row from its quad's first lane
  const int dn[2] = {__shfl_sync(0xffffffffu, st.den[0], lane & ~3),
                     __shfl_sync(0xffffffffu, st.den[2], lane & ~3)};
  if (!live) return;
  int8_t* orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    orow[r] = a.out + ((size_t)q_head(warp) * a.sq + row[r]) * a.d;
  const int ndb = g.dp >> 3;
#pragma unroll
  for (int n = 0; n < 4 * DT; ++n) {
    if (n < ndb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * n + 2 * (lane & 3) + (e & 1);
        if (row[r] < a.sq && col < a.d) {
          const float den = __int2float_rn(max(dn[r], 1));
          float y = __fmul_rn(__fdiv_rn(__int2float_rn(st.acc[n][e]), den),
                              a.out_mult);
          y = truncf(__fadd_rn(y, y >= 0.f ? 0.5f : -0.5f));
          orow[r][col] = (int8_t)(int)fminf(fmaxf(y, -127.f), 127.f);
        }
      }
    }
  }
}

template <int KT, int DT>
cudaError_t launch(const Args& a, int grid, int bytes, cudaStream_t stream) {
  static int opted_in = 48 << 10;          // the default dynamic limit
  if (bytes > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ita_attention_kernel<KT, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in = bytes;
  }
  ita_attention_kernel<KT, DT><<<grid, 32 * a.warps, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_kt(const Args& a, int dp, int grid, int bytes,
                      cudaStream_t stream) {
  if (dp <= 128) return launch<KT, 4>(a, grid, bytes, stream);
  return launch<KT, 8>(a, grid, bytes, stream);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [nbh, sq, d], k/v [nbh / group, skv, d] int8 → out [nbh, sq, d] int8.
// Requires bq | sq, bkv | skv, 1 <= bkv <= 256, 1 <= d <= 256 and
// 0 <= ar <= 31; q head i reads kv head i / group. warps (a block: 4 or
// 8, 16 query rows each), hpb (query heads a block, dividing group and
// warps) and stages (1 or 2) are the host's plan
// (repro_torch/kernels/ita_attention/ops.py plan).
int ita_attention_launch(const void* q, const void* k, const void* v,
                         void* out, int nbh, int group, int sq, int skv,
                         int d, int bq, int bkv, int causal, int qk_mult,
                         int qk_shift, int am, int ar, float out_mult,
                         int warps, int hpb, int stages, void* stream) {
  if (nbh < 1 || group < 1 || nbh % group || sq < 1 || bq < 1 ||
      bkv < 1 || bkv > MAX_BKV || skv % bkv || d < 1 || d > MAX_D ||
      (warps != 4 && warps != MAX_WARPS) ||
      hpb < 1 || warps % hpb || group % hpb || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  const Geo g(d, bkv, stages, warps);
  if (g.bytes() > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const int8_t*)q;
  a.k = (const int8_t*)k;
  a.v = (const int8_t*)v;
  a.out = (int8_t*)out;
  a.group = group;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.bq = bq;
  a.bkv = bkv;
  a.causal = causal;
  a.qk_mult = qk_mult;
  a.qk_shift = qk_shift;
  a.am = am;
  a.ar = ar;
  a.out_mult = out_mult;
  a.hpb = hpb;
  a.warps = warps;
  a.stages = stages;
  const int ppb = 16 * (warps / hpb);
  a.npb = (sq + ppb - 1) / ppb;
  // 16-byte staging needs whole chunks at aligned addresses
  a.vec = d % 16 == 0 &&
          ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const long long grid = (long long)a.npb * (nbh / hpb);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.kpad <= 128)
    return (int)launch_kt<4>(a, g.dp, (int)grid, g.bytes(), s);
  return (int)launch_kt<8>(a, g.dp, (int)grid, g.bytes(), s);
}

}  // extern "C"
