// Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py:66 ssd_scan_pallas (body
//   _ssd_kernel), and the state it keeps in VMEM scratch across the
//   sequential chunk axis, which this kernel also writes out (the serving
//   prefill needs it; the reference computes the same state through the xla
//   form of the op, ops._ssd_chunked_xla with return_state=True).
// Contract: allclose with repro_torch/kernels/ssd_scan/ref.py
//   ssd_scan_chunked_ref (float32 throughout, only the order of additions
//   and the split of each product differ). For each (batch, head), over
//   chunks of L rows, with s = cumsum(dta) over the chunk:
//     y[t]   = sum_{tau<=t} (C_t.B_tau) exp(s_t - s_tau) x_tau
//            + exp(s_t) C_t.state_in
//     state' = exp(s_last) state_in + sum_tau exp(s_last - s_tau) B_tau x_tau^T
//   Head h reads group h / (H/G). A ragged last chunk (S % L != 0) acts as
//   the reference's zero padding (dta = 0, B = 0, outputs dropped): the
//   kernels run that chunk over its `len` real rows and zero-fill the rest.
//
// What bounds it: operations. The function needs, per chunk of L = 128
//   rows, C.B^T over tau <= t once per group (L.(L+1).N flops) and per head
//   scores.x over tau <= t (L.(L+1).P), C.state and B^T.x (2.L.N.P each):
//   1.69 GFLOP at mamba2-2.7b's one-prompt 512-token prefill (H = 80,
//   P = 64, N = 128, G = 1) against 11 MB of inputs and outputs.
// The product unit and its precision: the gate is float32, so the products
//   run on the tensor cores in split TF32 ("3xTF32"): each operand is
//   a = hi + lo with hi = a cut to TF32's 10 fraction bits and lo = a - hi
//   (exact; the tensor core reads TF32's bits of it), and a.b is summed as
//   lo.hi + hi.lo + hi.hi by mma.sync m16n8k8 with f32 accumulators (lo.lo
//   is dropped): below 2^-20 relative per product, against TF32's 2^-10.
//   The bound is then three times the flops at 495 TF/s; mma.sync itself
//   reaches well under that rate (PERF.md), and the fragment work beside
//   it (loads, splits, decays) takes as many issue slots again.
// What the design does about it (the SSD decomposition; one C entry, two
//   or three launches on one stream, no float atomics, so y is the same
//   bits run to run and with or without the state):
//   1. local (grid: 2.B.G.nc + B.H.ncs.ptiles blocks): the first 2.B.G.nc
//      blocks form C.B^T of one (batch, group, chunk) and 64 of its
//      columns over the lower triangle only (8-column tiles above a
//      16-row strip's last row are never multiplied) into a workspace,
//      once per group and never per head; the rest form each (batch, head,
//      chunk, 64 columns of P)'s local state
//      Sc = sum_tau exp(s_last - s_tau) B_tau x_tau^T and exp(s_last).
//      Every chunk is independent, so the card fills with (head, chunk)
//      units: 328 blocks at a 512-token mamba2-2.7b prompt.
//   2. chain (only when there are 2 or more chunks): one thread per four
//      state entries walks the chunks in order, state_c = exp(s_last,c)
//      state_{c-1} + Sc, with eight chunks of loads in flight, and leaves in
//      the workspace the state entering each chunk (and writes the final
//      state).
//   3. output (grid: B.H.nc.ptiles): y = (C.B^T o exp(s_t - s_tau))[tau<=t].x
//      + exp(s_t) C.state_in, as one product over K = the chunk's taus then
//      (after chunk 0) N. Row strips are dealt to warps in pairs (i, 7 - i),
//      so the causal skip (a k-step above a strip's last row is never
//      loaded into registers or multiplied) leaves every warp the same
//      work. exp is formed only where tau <= t, so no inf.0 is ever formed.
//   Every block walks its K dimension in 32-deep slices staged by
//   zero-filling 16-byte cp.async (each thread at fixed offsets) into two
//   buffers, the next slice landing while one is multiplied: 55 KB of
//   dynamic shared memory a block, 2 blocks an SM at <= 128 registers.
//   Rows are padded so that every fragment load is free of bank conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int LMAX = 128;             // chunk rows
constexpr int NMAX = 128;             // state size N
constexpr int PT = 64;                // columns of P a block owns
constexpr int KT = 32;                // depth of a staged slice
// shared-memory row strides (floats): fragment loads hit 32 distinct banks
constexpr int SA = KT + 4;            // [rows][KT] tiles, read along K
constexpr int SBT = NMAX + 8;         // [KT][N] tile read as A^T
constexpr int SX = PT + 8;            // [KT][PT] tiles read as the B operand
constexpr int CHAIN_BATCH = 8;        // chunks of loads in flight in the chain

// one slice of each block's K walk; two are in shared memory (the next
// lands while this one is multiplied)
constexpr int CB_STAGE = (LMAX + 64) * SA;       // C and B slices
constexpr int ST_STAGE = KT * SBT + KT * SX;     // B and x slices
constexpr int OUT_STAGE = LMAX * SA + KT * SX;   // A slice and B slice
constexpr int MIN_BLOCKS = 2;         // resident blocks an SM (registers)
constexpr int LOCAL_RING = 2 * (CB_STAGE > ST_STAGE ? CB_STAGE : ST_STAGE);
constexpr size_t LOCAL_SMEM = (size_t)(LOCAL_RING + 2 * LMAX) * sizeof(float);
constexpr size_t OUT_SMEM = (size_t)(2 * OUT_STAGE + 2 * LMAX) * sizeof(float);

struct Args {
  const float* dta;   // [B, H, S]
  const float* x;     // [B, H, S, P]
  const float* b;     // [B, G, S, N]
  const float* c;     // [B, G, S, N]
  float* y;           // [B, H, S, P]
  float* state_out;   // [B, H, N, P] or null
  float* cb;          // [B, G, nc, LMAX, LMAX] C.B^T, lower triangle
  float* sc;          // [B, H, nc, N, P] local states, then entering states
                      // (state_out itself when there is one chunk)
  float* decay;       // [B, H, nc] exp(s_last) of each chunk
  int B, H, G, S, N, P, L;
  int nc;             // chunks
  int ncs;            // chunks whose local state is needed
  int ptiles;         // 64-column tiles of P
};

// state entries a chain thread carries
inline int chain_width(int N, int P) {
  return (N * P) % 4 == 0 ? 4 : 1;
}

// The launches and the workspace of one call (ssd_scan_plan reports it,
// ssd_scan_launch runs it).
struct Plan {
  int nc, ncs, ptiles;
  long long cb_floats, sc_floats, decay_floats;
  long long grid_local, grid_chain, grid_out;
};

inline Plan make_plan(int B, int H, int G, int S, int N, int P, int L,
                      bool with_state) {
  Plan p;
  p.nc = (S + L - 1) / L;
  p.ncs = with_state ? p.nc : p.nc - 1;
  p.ptiles = (P + PT - 1) / PT;
  p.cb_floats = (long long)B * G * p.nc * LMAX * LMAX;
  p.sc_floats = p.nc > 1 ? (long long)B * H * p.nc * N * P : 0;
  p.decay_floats = (long long)B * H * p.nc;
  p.grid_local =
      2LL * B * G * p.nc + (long long)B * H * p.ncs * p.ptiles;
  p.grid_chain = p.nc > 1
      ? ((long long)B * H * N * P / chain_width(N, P) + THREADS - 1) / THREADS
      : 0;
  p.grid_out = (long long)B * H * p.nc * p.ptiles;
  return p;
}

// -- staging -----------------------------------------------------------------

// global → shared without passing through registers; ok = false writes
// zeros and reads nothing (src is then any valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows (<= MAXROWS) x COLS floats of src (row stride ld) into dst (row
// stride SD); entries at row >= vrows or column >= vcols are zero-filled.
// VEC: 16-byte copies (vcols, ld and both addresses multiples of 4 floats),
// each thread at a fixed column and every (256 / (COLS / 4))-th row.
template <bool VEC, int COLS, int MAXROWS, int SD>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld,
                                      int rows, int vrows, int vcols) {
  if (VEC) {
    constexpr int CPR = COLS / 4, RSTEP = THREADS / CPR;
    static_assert(THREADS % CPR == 0 && MAXROWS % RSTEP == 0, "tile shape");
    const int r0 = threadIdx.x / CPR, q = (threadIdx.x % CPR) * 4;
    const bool col_ok = q < vcols;
    const float* s0 = src + (size_t)r0 * ld + q;
    const size_t step = (size_t)RSTEP * ld;
    float* d0 = dst + r0 * SD + q;
#pragma unroll
    for (int k = 0; k < MAXROWS / RSTEP; ++k) {
      const int r = r0 + k * RSTEP;
      if (r < rows) {
        const bool ok = col_ok && r < vrows;
        cp_async16(d0 + k * RSTEP * SD, ok ? s0 + k * step : src, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
      const int r = i / COLS, q = i % COLS;
      const bool ok = r < vrows && q < vcols;
      cp_async4(dst + r * SD + q, ok ? src + (size_t)r * ld + q : src, ok);
    }
  }
}

// s[t] = dta[0] + ... + dta[t] over the chunk (rows past len add 0): warp
// 0, four consecutive rows a lane. Every kernel forms s the same way.
__device__ __forceinline__ void chunk_cumsum(const float* dta, int len,
                                             float* s) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    run += t < len ? dta[t] : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s[4 * lane + k] = excl + v[k];
}

// exp(d) for the decay between two rows, d = s_t - s_tau <= 0: the
// difference is formed first (exact to its own ulp), then 2^(d log2 e) on
// the SFU (relative error about 2^-22, as expf's)
__device__ __forceinline__ float exp_diff(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

// -- split-TF32 tensor-core products -----------------------------------------

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// hi: v cut to TF32's 10 fraction bits; lo = v - hi (exact), whose bits
// past TF32's the tensor core ignores: with a and b so split,
// |a.b - (lo.hi + hi.lo + hi.hi)| is below 2^-20 |a.b|
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// D (16x8) += A (16x8 tf32, row) . B (8x8 tf32, col), f32 accumulation.
// Fragments (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g+8, q),
// a2 (g, q+4), a3 (g+8, q+4); b0 (k q, n g), b1 (k q+4, n g);
// c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32: the two small terms first, then hi.hi
__device__ __forceinline__ void mma3(float* c, const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// two adjacent outputs of a C fragment into a row of width `cols`
__device__ __forceinline__ void store2(float* row, int col, int cols, float v0,
                                       float v1) {
  if (col + 1 < cols && !(cols & 1)) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < cols) row[col] = v0;
    if (col + 1 < cols) row[col + 1] = v1;
  }
}

// -- 1. local: C.B^T per (batch, group, chunk), Sc per (batch, head, chunk) --

// C.B^T over the lower triangle, 64 columns (tau) a block: idx = (batch,
// group, chunk, half). Warp w owns the 16-row strips w/2 and 7 - w/2 and
// the 32 columns 64 half + 32 (w%2), in 8-column tiles.
template <bool VEC>
__device__ __forceinline__ void cb_block(const Args& a, int idx, float* sm) {
  const int half = idx & 1;
  const int c = (idx >> 1) % a.nc;
  const int bg = (idx >> 1) / a.nc;
  const int c0 = c * a.L, len = min(a.L, a.S - c0);
  const int tau0 = 64 * half;
  if (tau0 >= len) return;
  const int rows = min(LMAX, (len + 15) & ~15);
  const float* cg = a.c + ((size_t)bg * a.S + c0) * a.N;
  const float* bgp = a.b + ((size_t)bg * a.S + c0 + tau0) * a.N;
  float* out = a.cb + (size_t)(idx >> 1) * LMAX * LMAX;
  const int nsl = (a.N + KT - 1) / KT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int st[2] = {warp >> 1, 7 - (warp >> 1)};
  const int col0 = tau0 + 32 * (warp & 1);

  auto issue = [&](int sl) {
    if (sl < nsl) {
      float* cs = sm + (sl & 1) * CB_STAGE;
      const int vc = a.N - sl * KT;
      stage<VEC, KT, LMAX, SA>(cs, cg + sl * KT, a.N, rows, len, vc);
      stage<VEC, KT, 64, SA>(cs + LMAX * SA, bgp + sl * KT, a.N, 64,
                             len - tau0, vc);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // strip i meets column tile j below the diagonal and inside the chunk
  auto use = [&](int i, int j) {
    const int n0 = col0 + 8 * j;
    return 16 * st[i] < len && n0 < len && n0 <= 16 * st[i] + 15;
  };

  issue(0);
  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<0>();
    __syncthreads();   // slice sl landed; slice sl - 1's buffer is free
    issue(sl + 1);
    const float* cs = sm + (sl & 1) * CB_STAGE;
    const float* bs = cs + LMAX * SA;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      if (sl * KT + kk >= a.N) break;
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* r = cs + (16 * st[i] + g) * SA + kk + q;
        fa[i] = frag_a(r[0], r[8 * SA], r[4], r[8 * SA + 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!use(0, j) && !use(1, j)) continue;
        const float* r = bs + (col0 - tau0 + 8 * j + g) * SA + kk + q;
        const FragB fb = frag_b(r[0], r[4]);
        if (use(0, j)) mma3(acc[0][j], fa[0], fb);
        if (use(1, j)) mma3(acc[1][j], fa[1], fb);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!use(i, j)) continue;
      float* r = out + (size_t)(16 * st[i] + g) * LMAX + col0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(r) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(r + 8 * LMAX) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// Sc[n][p] = sum_tau (B[tau][n] w[tau]) x[tau][p], w = exp(s_last - s):
// rows n in 16-row strips (w/2, 7 - w/2), columns p half w%2.
template <bool VEC>
__device__ __forceinline__ void state_block(const Args& a, int idx, float* sm) {
  const int pt = idx % a.ptiles;
  int r = idx / a.ptiles;
  const int c = r % a.ncs;
  const int bh = r / a.ncs;
  const int h = bh % a.H, bb = bh / a.H;
  const int grp = h / (a.H / a.G);
  const int c0 = c * a.L, len = min(a.L, a.S - c0);
  const int p0 = pt * PT, pv = a.P - p0;
  const float* bsrc = a.b + ((size_t)(bb * a.G + grp) * a.S + c0) * a.N;
  const float* xsrc = a.x + ((size_t)bh * a.S + c0) * a.P + p0;
  float* s = sm + LOCAL_RING;
  float* w = s + LMAX;
  const int nsl = (len + KT - 1) / KT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int st[2] = {warp >> 1, 7 - (warp >> 1)};
  const int ch = (warp & 1) * 32;

  auto issue = [&](int sl) {
    if (sl < nsl) {
      float* bt = sm + (sl & 1) * ST_STAGE;
      const int t0 = sl * KT;
      stage<VEC, NMAX, KT, SBT>(bt, bsrc + (size_t)t0 * a.N, a.N, KT,
                                len - t0, a.N);
      stage<VEC, PT, KT, SX>(bt + KT * SBT, xsrc + (size_t)t0 * a.P, a.P, KT,
                             len - t0, pv);
    }
    cp_async_commit();
  };

  issue(0);
  chunk_cumsum(a.dta + (size_t)bh * a.S + c0, len, s);
  __syncthreads();
  const float s_last = s[len - 1];
  if (threadIdx.x < LMAX)
    w[threadIdx.x] = threadIdx.x < len ? expf(s_last - s[threadIdx.x]) : 0.f;
  if (pt == 0 && threadIdx.x == 0)
    a.decay[(size_t)bh * a.nc + c] = expf(s_last);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<0>();
    __syncthreads();   // slice sl landed; slice sl - 1's buffer is free
    issue(sl + 1);
    const float* bt = sm + (sl & 1) * ST_STAGE;
    const float* xt = bt + KT * SBT;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      const int k0 = sl * KT + kk;
      if (k0 >= len) break;
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* xr = xt + (kk + q) * SX + ch + 8 * j + g;
        fb[j] = frag_b(xr[0], xr[4 * SX]);
      }
      const float w0 = w[k0 + q], w1 = w[k0 + q + 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* br = bt + (kk + q) * SBT + 16 * st[i] + g;
        const FragA fa = frag_a(br[0] * w0, br[8] * w0, br[4 * SBT] * w1,
                                br[4 * SBT + 8] * w1);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[i][j], fa, fb[j]);
      }
    }
  }

  float* out = a.sc + ((size_t)bh * a.nc + c) * a.N * a.P;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 16 * st[i] + g, col = p0 + ch + 8 * j + 2 * q;
      if (n < a.N) store2(out + (size_t)n * a.P, col, a.P, acc[i][j][0],
                          acc[i][j][1]);
      if (n + 8 < a.N) store2(out + (size_t)(n + 8) * a.P, col, a.P,
                              acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ssd_local_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n_cb = 2 * a.B * a.G * a.nc;
  if ((int)blockIdx.x < n_cb) cb_block<VEC>(a, blockIdx.x, sm);
  else state_block<VEC>(a, blockIdx.x - n_cb, sm);
}

// -- 2. chain: the states entering each chunk, in chunk order ----------------

__device__ __forceinline__ void ld_cg(const float* p, float (&v)[4]) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void ld_cg(const float* p, float (&v)[1]) {
  v[0] = __ldcg(p);
}
__device__ __forceinline__ void st(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[1]) { *p = v[0]; }

// W consecutive state entries a thread (4 when N.P % 4 == 0, else 1)
template <int W>
__global__ void __launch_bounds__(THREADS) ssd_chain_kernel(Args a) {
  const size_t np = (size_t)a.N * a.P;
  const size_t e = ((size_t)blockIdx.x * THREADS + threadIdx.x) * W;
  if (e >= (size_t)a.B * a.H * np) return;
  const size_t bh = e / np;
  float* sc = a.sc + bh * a.nc * np + e % np;
  const float* dec = a.decay + bh * a.nc;
  float run[W];
#pragma unroll
  for (int i = 0; i < W; ++i) run[i] = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += CHAIN_BATCH) {
    float v[CHAIN_BATCH][W];
#pragma unroll
    for (int k = 0; k < CHAIN_BATCH; ++k)
      if (c0 + k < a.ncs) ld_cg(sc + (c0 + k) * np, v[k]);
#pragma unroll
    for (int k = 0; k < CHAIN_BATCH; ++k) {
      const int c = c0 + k;
      if (c >= a.nc) break;
      if (c > 0) st(sc + c * np, run);   // entering chunk 0: 0, never read
      if (c < a.ncs) {
        const float d = dec[c];
#pragma unroll
        for (int i = 0; i < W; ++i) run[i] = fmaf(d, run[i], v[k][i]);
      }
    }
  }
  if (a.state_out != nullptr) st(a.state_out + e, run);
}

// -- 3. output: y = scores.x + exp(s_t) C.state_in ---------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ssd_output_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s = sm + 2 * OUT_STAGE;
  float* es = s + LMAX;

  int r = blockIdx.x;
  const int pt = r % a.ptiles;
  r /= a.ptiles;
  const int h = r % a.H;
  r /= a.H;
  const int c = r % a.nc, bb = r / a.nc;
  const int bh = bb * a.H + h, grp = h / (a.H / a.G);
  const int c0 = c * a.L, len = min(a.L, a.S - c0);
  const int rows = min(LMAX, (len + 15) & ~15);
  const int p0 = pt * PT, pv = a.P - p0;
  const float* cbt = a.cb + ((size_t)(bb * a.G + grp) * a.nc + c) * LMAX * LMAX;
  const float* csrc = a.c + ((size_t)(bb * a.G + grp) * a.S + c0) * a.N;
  const float* xsrc = a.x + ((size_t)bh * a.S + c0) * a.P + p0;
  const float* ssrc = a.sc + ((size_t)bh * a.nc + c) * a.N * a.P + p0;
  const int n_intra = (len + KT - 1) / KT;
  const int nsl = n_intra + (c > 0 ? (a.N + KT - 1) / KT : 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int st[2] = {warp >> 1, 7 - (warp >> 1)};
  const int ch = (warp & 1) * 32;

  // intra slice j: C.B^T rows [32j, rows) x taus [32j, 32j + 32) and those
  // x rows; inter slice m: C rows [0, rows) x n [32m, 32m + 32) and those
  // state rows
  auto issue = [&](int sl) {
    float* at = sm + (sl & 1) * OUT_STAGE;
    float* bt = at + LMAX * SA;
    if (sl < n_intra) {
      const int t0 = sl * KT;
      stage<VEC, KT, LMAX, SA>(at + t0 * SA, cbt + (size_t)t0 * LMAX + t0,
                               LMAX, rows - t0, rows - t0, KT);
      stage<VEC, PT, KT, SX>(bt, xsrc + (size_t)t0 * a.P, a.P, KT, len - t0,
                             pv);
    } else if (sl < nsl) {
      const int n0 = (sl - n_intra) * KT;
      stage<VEC, KT, LMAX, SA>(at, csrc + n0, a.N, rows, len, a.N - n0);
      stage<VEC, PT, KT, SX>(bt, ssrc + (size_t)n0 * a.P, a.P, KT, a.N - n0,
                             pv);
    }
    cp_async_commit();
  };

  issue(0);
  chunk_cumsum(a.dta + (size_t)bh * a.S + c0, len, s);
  __syncthreads();
  if (threadIdx.x < LMAX)
    es[threadIdx.x] = threadIdx.x < len ? expf(s[threadIdx.x]) : 0.f;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<0>();
    __syncthreads();   // slice sl landed; slice sl - 1's buffer is free
    issue(sl + 1);
    const float* at = sm + (sl & 1) * OUT_STAGE;
    const float* bt = at + LMAX * SA;
    const bool intra = sl < n_intra;
    const int kbase = intra ? sl * KT : (sl - n_intra) * KT;
    const int kend = intra ? len : a.N;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      const int k0 = kbase + kk;
      if (k0 >= kend) break;
      // strips that this k-step reaches: below the diagonal for the taus
      bool use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        use[i] = 16 * st[i] < len && (!intra || k0 <= 16 * st[i] + 15);
      if (!use[0] && !use[1]) continue;
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = bt + (kk + q) * SX + ch + 8 * j + g;
        fb[j] = frag_b(br[0], br[4 * SX]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!use[i]) continue;
        const int t = 16 * st[i] + g;
        const float* ar = at + t * SA + kk + q;
        float v[4] = {ar[0], ar[8 * SA], ar[4], ar[8 * SA + 4]};
        if (intra) {
          // scores: exp only where tau <= t < len
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tt = t + (e & 1) * 8, tau = k0 + q + (e >> 1) * 4;
            v[e] = tau <= tt && tt < len ? v[e] * exp_diff(s[tt] - s[tau])
                                         : 0.f;
          }
        } else {
          v[0] *= es[t];
          v[1] *= es[t + 8];
          v[2] *= es[t];
          v[3] *= es[t + 8];
        }
        const FragA fa = frag_a(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[i][j], fa, fb[j]);
      }
    }
  }

  float* yg = a.y + ((size_t)bh * a.S + c0) * a.P;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 16 * st[i] + g, col = p0 + ch + 8 * j + 2 * q;
      if (t < len) store2(yg + (size_t)t * a.P, col, a.P, acc[i][j][0],
                          acc[i][j][1]);
      if (t + 8 < len) store2(yg + (size_t)(t + 8) * a.P, col, a.P,
                              acc[i][j][2], acc[i][j][3]);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool valid(int B, int H, int G, int S, int N, int P, int chunk) {
  return B >= 1 && H >= 1 && S >= 1 && P >= 1 && N >= 1 && N <= NMAX
         && chunk >= 1 && chunk <= LMAX && G >= 1 && H % G == 0;
}

template <bool VEC>
cudaError_t launch_all(const Args& a, const Plan& pl, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_local_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)LOCAL_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_output_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)OUT_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  ssd_local_kernel<VEC><<<(unsigned)pl.grid_local, THREADS, LOCAL_SMEM,
                          stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (pl.grid_chain > 0) {
    if (chain_width(a.N, a.P) == 4)
      ssd_chain_kernel<4><<<(unsigned)pl.grid_chain, THREADS, 0, stream>>>(a);
    else
      ssd_chain_kernel<1><<<(unsigned)pl.grid_chain, THREADS, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_output_kernel<VEC><<<(unsigned)pl.grid_out, THREADS, OUT_SMEM,
                           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch plan of one call: out = {workspace bytes, CUDA launches,
// blocks of the local, chain and output launches}. Returns 0, or
// cudaErrorInvalidValue for sizes the kernels do not take.
int ssd_scan_plan(int B, int H, int G, int S, int N, int P, int chunk,
                  int with_state, long long* out) {
  if (!valid(B, H, G, S, N, P, chunk)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, G, S, N, P, chunk, with_state != 0);
  out[0] = (p.cb_floats + p.sc_floats + p.decay_floats) * (long long)sizeof(float);
  out[1] = p.grid_chain > 0 ? 3 : 2;
  out[2] = p.grid_local;
  out[3] = p.grid_chain;
  out[4] = p.grid_out;
  return 0;
}

// dta [B,H,S], x [B,H,S,P], b/c [B,G,S,N] float32 → y [B,H,S,P] float32 and,
// when state_out is not null, the final state [B,H,N,P] float32. ws: the
// workspace of ssd_scan_plan's size (no initial contents needed).
// Requires 1 <= chunk <= 128, N <= 128, H % G == 0.
int ssd_scan_launch(const void* dta, const void* x, const void* b,
                    const void* c, void* y, void* state_out, void* ws, int B,
                    int H, int G, int S, int N, int P, int chunk,
                    cudaStream_t stream) {
  if (!valid(B, H, G, S, N, P, chunk)) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(B, H, G, S, N, P, chunk, state_out != nullptr);
  float* w = (float*)ws;
  Args a{(const float*)dta, (const float*)x, (const float*)b,
         (const float*)c, (float*)y, (float*)state_out,
         w, w + pl.cb_floats, w + pl.cb_floats + pl.sc_floats,
         B, H, G, S, N, P, chunk, pl.nc, pl.ncs, pl.ptiles};
  if (pl.nc == 1) a.sc = (float*)state_out;   // the one local state is final
  const bool vec = N % 4 == 0 && P % 4 == 0 && aligned16(x) && aligned16(b)
                   && aligned16(c) && aligned16(ws);
  return (int)(vec ? launch_all<true>(a, pl, stream)
                   : launch_all<false>(a, pl, stream));
}

}  // extern "C"
