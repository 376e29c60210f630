// Paged attention over a block pool, for sm_90a: one-token decode and the
// small-q speculative verify step, as split-KV flash decoding.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py
//   * paged_attention_pallas (body _paged_kernel) — float pools (bf16/f32);
//   * paged_attention_int8_pallas (body _paged_int8_kernel) — int8 pools
//     with per-block scales: q requantized by Q_SCALE (round half even),
//     exact int32 q8·k8 score dots scaled by q_scale·k_scale[block], the V
//     scale folded into each key's probability;
//   * paged_attention_verify_pallas (body _paged_verify_kernel) and
//     paged_attention_verify_int8_pallas (_paged_verify_int8_kernel) — the
//     same two over Q = spec_tokens + 1 query rows per batch row, folded
//     into the GQA group axis (row g·Q + j is query j of head g) with row
//     j attending lens + j keys.
// Contract: allclose with repro_torch/kernels/paged_attention/ref.py
//   (paged_attention_ref, paged_attention_int8_dequant_ref and their
//   verify versions): the split softmax only reorders f32 additions.
//   Length mask, optional sliding window, per-row start offset; rows with
//   lens == 0 write zeros.
//
// What bounds it: decode reads each row's live K/V blocks once — bytes,
//   not operations (a GQA group of G query heads does 4·G flops per K/V
//   element pair, verify 4·G·Q). At serving sizes a call moves a few MB
//   (glm4-9b decode, 8 rows up to 544 keys: about 1.5 MB, under 0.5 µs at
//   3.35 TB/s),
//   so the kernel is bound by latency: the chain of dependent round trips
//   to memory on the longest row's path (lens and the table, the K/V tile,
//   the partials and the ticket, the combine's reads), and how many SMs
//   share the walk.
// The design:
//   * Split-KV (flash decoding). The grid is (split, kv head × row chunk,
//     batch row). A split owns `split_e` consecutive table entries; the
//     host chooses split_e from the table width M, the block length, the
//     head dim and the pool type only (ops.split_plan: at most 16 splits a
//     row; glm4-9b decode at M = 34–36 gets 9 splits of 64 keys, 144
//     blocks). Splits before the window's first entry or past the last
//     live entry exit at once. A split writes the running max m, sum l and
//     unnormalised f32 accumulator of each folded row to a workspace; the
//     last split of a row to finish (a ticket per (row, kv head, chunk),
//     taken with one atomicAdd after a fence; the wrapper's launch zeroes
//     the tickets with a memset) rescales the partials and adds them in
//     split order, skipping splits whose m is −inf, and normalises. A row
//     with one live split normalises in place and touches no workspace.
//   * Round trips overlapped. The split's block ids (and int8 scales) and
//     the q rows are fetched with the lens read, not after it; K/V tiles of
//     `tile_e` entries (64 keys at block_len 16; 32 where a key row is
//     ≥ 512 bytes, 16 where ≥ 1 KB) come by 16-byte cp.async, double-buffered so the next
//     tile loads while this one computes, entries outside the walk
//     zero-filled by the copy itself. K and V stay in their pool type in
//     shared memory; K rows are padded by 16 bytes so the fragment loads of
//     eight rows land in distinct banks. Divisions by block_len and Q are
//     done once per block into small tables.
//   * Tensor-core scores where the inputs are exact in the MMA type: int8
//     pools run mma.sync m16n8k32 s8·s8→s32 on the requantized q8 and the
//     int8 K (exact, so any order); bf16 q over bf16 pools runs m16n8k16
//     bf16 with f32 accumulation, rsd applied to the f32 score after the
//     dot. All 16 query heads of glm4-9b's GQA group are one m16 tile and
//     its verify's 80 folded rows five, so one block holds every row of a
//     (row, kv head) (up to 112 rows; more go to row chunks). f32 pools
//     and f32 q over bf16 pools keep f32 dots on the CUDA cores, each dot
//     sequential over d.
//   * Softmax over the whole tile, 8 lanes a row (4 rows a warp). P·V as
//     f32 FMAs on the CUDA cores for every pool type, accumulators in
//     shared memory: a thread owns 8 columns of its rows and takes them
//     four at a time, so a V row is read (and widened; s8 by a byte
//     permute into 2^23's mantissa, not the quarter-rate I2F) once for four
//     rows. On int8 pools each probability is scaled by its block's
//     v_scale before the product, as the plain version does.
// Verify and bit-equality with decode: decode is verify at Q = 1 through
//   the same compiled body. The split and tile boundaries are functions of
//   the entry index (M, block_len, head dim, pool type), never of Q, and
//   every per-row operation — the dot (exact for s8; a per-element
//   tensor-core or sequential dot for float), the tile's max and sum tree
//   (fixed by the tile width), the P·V order, the combine's split order —
//   depends only on that row's own values. Verify walks to lens + Q − 1,
//   at most one entry further than decode: for row 0 those keys are
//   masked (score −inf → p = 0, and zero-filled K/V in decode are never
//   read unmasked), a tile past decode's last is a no-op (alpha = 1, +0),
//   and a split past decode's last has m = −inf and is skipped by the
//   combine. A row with one live split normalises acc/l in place; through
//   the combine the same row gets fmaf(1, acc, 0)/fmaf(1, l, 0), the same
//   bits. So verify at Q = 1 is decode bit for bit, and row 0 at any Q
//   equals decode at the same lens.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_ROWS = 112;    // folded query rows per block
constexpr int MAX_ACC = 16384;   // rows × D accumulators per block (64 KB)
constexpr int MAX_SPLITS = 16;   // splits per row (ops.MAX_SPLITS)
constexpr int MAX_TILE = 256;    // keys per staged tile
constexpr int MAX_D = 256;
constexpr int SMEM_LIMIT = 232448;

enum Mode { FMA = 0, MMA_BF16 = 1, MMA_S8 = 2 };

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
  int* ws_count;        // [B, Hkv, chunks] tickets
  float* ws_ml;         // [B, Hkv, nsplit, R, 2] m, l
  float* ws_acc;        // [B, Hkv, nsplit, R, D] unnormalised accumulators
  int B, Hq, Hkv, D, N, blk, M, window;  // window < 0: none
  int Q;                // query rows per batch row (1: decode)
  int rows;             // folded rows per block (row chunk)
  int chunks;
  int tile_e;           // table entries per staged tile
  int split_e;          // table entries per split (a multiple of tile_e)
  int nsplit;
  int T;                // keys per staged tile, tile_e·blk rounded up to 16
  float rsd;            // float32(D^-0.5)
  float q_scale;        // float32(Q_SCALE)
  float q_inv;          // float32(1) / float32(Q_SCALE)
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// eight consecutive values from shared memory, widened to f32
__device__ __forceinline__ void ld8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 → f32 is a 16-bit shift, exactly
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ld8(const int8_t* p, float* x) {
  // s8 → f32 without the quarter-rate I2F: bias each byte to u8 (x + 128),
  // place it in the mantissa of 2^23, subtract 2^23 + 128 (all exact)
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4b000000u, 0x7650 + (i & 3)))
           - 8388736.f;
}

// eight q values held as raw 16-byte words (bf16: one word, f32: two),
// widened to f32 register to register
template <typename QT> __device__ __forceinline__ void unpack8(const uint4* r, float* x);
template <> __device__ __forceinline__ void unpack8<__nv_bfloat16>(const uint4* r, float* x) {
  const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void unpack8<float>(const uint4* r, float* x) {
  const uint32_t w[8] = {r[0].x, r[0].y, r[0].z, r[0].w, r[1].x, r[1].y, r[1].z, r[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(w[i]);
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global → shared without passing through registers; ok = false
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D (16×8) += A (16×32 s8, row) · B (32×8 s8, col)
__device__ __forceinline__ void mma(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// D (16×8) += A (16×16 bf16, row) · B (16×8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline size_t align4(size_t x) { return (x + 3) & ~(size_t)3; }

// Row width in bytes of q and K in shared memory: s8 rows are padded to
// the MMA depth of 32 (zeros), and every row gets 16 bytes more so that
// consecutive rows start 4 banks apart.
__host__ __device__ inline int q_row_bytes(int mode, int D) {
  return mode == MMA_S8 ? ((D + 31) & ~31) : D * (mode == MMA_BF16 ? 2 : 4);
}
__host__ __device__ inline int k_row_bytes(int mode, int D, int kv_bytes) {
  return mode == MMA_S8 ? ((D + 31) & ~31) : D * kv_bytes;
}

// Shared-memory plan (bytes) for `rows` folded rows (a multiple of 16):
// q | K ×2 | V ×2 | scores [rows][T + 4] | accumulators [rows][D] |
// m, l, alpha | the split's block ids and scales | per key: entry, offset
// in the entry; per row: query index | flag
struct Layout {
  int qstride, kstride, vstride, sstride;  // sstride in floats
  int kbuf, vbuf, q_off, k_off, v_off, s_off, acc_off, st_off, e_off,
      t_off, flag_off, bytes;
};
__host__ __device__ inline Layout make_layout(int mode, int kv_bytes, int rows,
                                              int D, int T, int split_e) {
  Layout L;
  L.qstride = q_row_bytes(mode, D) + 16;
  L.kstride = k_row_bytes(mode, D, kv_bytes) + 16;
  L.vstride = D * kv_bytes;
  L.sstride = T + 4;
  L.kbuf = T * L.kstride;
  L.vbuf = T * L.vstride;
  L.q_off = 0;
  L.k_off = align16(rows * L.qstride);
  L.v_off = L.k_off + 2 * L.kbuf;
  L.s_off = align16(L.v_off + 2 * L.vbuf);
  // the combine reuses the score tile for m, l of up to MAX_SPLITS splits
  L.acc_off = L.s_off + align16(rows * max(L.sstride, 2 * MAX_SPLITS) * 4);
  L.st_off = L.acc_off + rows * D * 4;
  L.e_off = L.st_off + align16(3 * rows * 4);
  L.t_off = L.e_off + align16(3 * split_e * 4);
  L.flag_off = L.t_off + align16((2 * T + rows) * 4);
  L.bytes = L.flag_off + 16;
  return L;
}

// rows r, r + rstep, ... (NR of them), columns dg·8 .. +8:
// acc = acc·alpha + Σ_{j < key_end} p[row][j] · V[j], keys in order
template <int NR, typename KT>
__device__ __forceinline__ void pv_rows(float* acc_s, const float* s_s, const float* a_s,
                                        const KT* vcol, int D, int sstride, int key_end,
                                        int r, int rstep, int dg) {
  float a[NR][8];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const int row = r + n * rstep;
    ld8(acc_s + row * D + dg * 8, a[n]);
    const float al = a_s[row];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[n][i] *= al;
  }
#pragma unroll 2
  for (int j = 0; j < key_end; ++j) {
    float x[8];
    ld8(vcol + j * D, x);
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const float pj = s_s[(r + n * rstep) * sstride + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[n][i] = fmaf(pj, x[i], a[n][i]);
    }
  }
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    float* dst = acc_s + (r + n * rstep) * D + dg * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(a[n][0], a[n][1], a[n][2], a[n][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(a[n][4], a[n][5], a[n][6], a[n][7]);
  }
}

template <typename QT, typename KT, int MODE>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, blk = p.blk, Q = p.Q, T = p.T;
  const int split = blockIdx.x, h = blockIdx.y % p.Hkv;
  const int chunk = blockIdx.y / p.Hkv, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = (p.Hq / p.Hkv) * Q;            // folded rows of the group
  const int r0 = chunk * p.rows;               // this chunk's first row
  const int G = min(p.rows, R - r0);           // rows of this chunk
  const int rows_pad = align16(p.rows);
  const Layout L = make_layout(MODE, (int)sizeof(KT), rows_pad, D, T, p.split_e);
  unsigned char* q_s = smem + L.q_off;
  unsigned char* k_s = smem + L.k_off;
  unsigned char* v_s = smem + L.v_off;
  float* s_s = reinterpret_cast<float*>(smem + L.s_off);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc_off);  // [rows][D]
  float* m_s = reinterpret_cast<float*>(smem + L.st_off);
  float* l_s = m_s + rows_pad;
  float* a_s = l_s + rows_pad;
  int* bid_s = reinterpret_cast<int*>(smem + L.e_off);       // [split_e]
  float* ks_s = reinterpret_cast<float*>(bid_s + p.split_e);  // q_scale·k_scale
  float* vs_s = ks_s + p.split_e;
  int* kent_s = reinterpret_cast<int*>(smem + L.t_off);  // key j: j / blk
  int* koff_s = kent_s + T;                               // (j % blk)·D
  int* rq_s = koff_s + T;                                 // row r: (r0 + r) % Q
  int* flag_s = reinterpret_cast<int*>(smem + L.flag_off);

  // folded row r of kv head h is query r % Q of head h·(Hq/Hkv) + r / Q;
  // in [B, Hq, Q, D] the group's R rows are contiguous
  const size_t row_base = ((size_t)b * p.Hq * Q + (size_t)h * R + r0) * D;
  QT* op = static_cast<QT*>(p.out) + row_base;
  const int s_e0 = split * p.split_e;
  const int* trow = p.table + (size_t)b * p.M;

  // Loads that do not depend on lens go out together with it: the split's
  // table entries (and int8 scales), and the chunk's q rows in the score
  // path's type (padding rows and columns zero).
  for (int j = tid; j < T; j += THREADS) {  // the only divisions by blk, Q
    kent_s[j] = j / blk;
    koff_s[j] = (j % blk) * D;
  }
  for (int r = tid; r < rows_pad; r += THREADS) rq_s[r] = (r0 + r) % Q;
  for (int e = tid; e < p.split_e; e += THREADS) {
    const int i = s_e0 + e;
    const int bid = i < p.M ? trow[i] : 0;
    bid_s[e] = bid;
    if (MODE == MMA_S8) {  // an entry past the row's end may hold anything
      const int cb = min(max(bid, 0), p.N - 1);
      ks_s[e] = p.q_scale * p.kscale[cb];
      vs_s[e] = p.vscale[cb];
    }
  }
  {
    // QB items of 8 values per thread in flight before any is stored
    constexpr int QB = 8;
    const QT* qp = static_cast<const QT*>(p.q) + row_base;
    const int per_row = q_row_bytes(MODE, D) / (MODE == MMA_S8 ? 1 : (MODE == MMA_BF16 ? 2 : 4)) / 8;
    const int n_items = rows_pad * per_row;
    for (int base = tid; base < n_items; base += QB * THREADS) {
      uint4 raw[QB][sizeof(QT) / 2];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = base + u * THREADS;
        const int r = e / per_row, d = (e - r * per_row) * 8;
        const bool in = e < n_items && r < G && d < D;
#pragma unroll
        for (int h2 = 0; h2 < (int)(sizeof(QT) / 2); ++h2)
          raw[u][h2] = in ? __ldg(reinterpret_cast<const uint4*>(qp + r * D + d) + h2)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = base + u * THREADS;
        if (e >= n_items) break;
        const int r = e / per_row, d = (e - r * per_row) * 8;
        unsigned char* dst = q_s + r * L.qstride;
        float x[8];
        unpack8<QT>(raw[u], x);
        if constexpr (MODE == MMA_S8) {
          uint32_t w[2] = {0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int8_t q8 = (int8_t)fminf(fmaxf(rintf(x[i] * p.rsd * p.q_inv), -127.f), 127.f);
            w[i >> 2] |= (uint32_t)(uint8_t)q8 << (8 * (i & 3));
          }
          *reinterpret_cast<uint2*>(dst + d) = make_uint2(w[0], w[1]);
        } else if constexpr (MODE == MMA_BF16) {
          *reinterpret_cast<uint4*>(dst + 2 * d) = raw[u][0];
        } else {
          *reinterpret_cast<float4*>(dst + 4 * d) = make_float4(x[0], x[1], x[2], x[3]);
          *reinterpret_cast<float4*>(dst + 4 * d + 16) = make_float4(x[4], x[5], x[6], x[7]);
        }
      }
    }
  }

  // table entries that hold a position in [max(start, lens - window),
  // lens + Q - 1): row 0's window starts first, the last row ends last
  const int len = p.lens[b];
  const int st = p.start ? p.start[b] : 0;
  const int len_max = len + Q - 1;
  const int n_ent = len_max > st ? min(p.M, (len_max - st + blk - 1) / blk) : 0;
  int first = 0;
  if (p.window >= 0 && len - p.window > st) first = (len - p.window - st) / blk;
  const int s_first = first / p.split_e;
  const int n_active = n_ent > first ? (n_ent - 1) / p.split_e - s_first + 1 : 0;
  if (n_active == 0) {  // nothing to attend: zeros (lens == 0 rows)
    if (split == 0)
      for (int e = tid; e < G * D; e += THREADS) op[e] = from_f<QT>(0.f);
    return;
  }
  if (split < s_first || split >= s_first + n_active) return;

  // this split's walk: entries [e_lo, e_hi), in tiles aligned to the split
  const int e_lo = max(s_e0, first), e_hi = min(s_e0 + p.split_e, n_ent);
  const int t_lo = (e_lo - s_e0) / p.tile_e;
  const int t_hi = (e_hi - 1 - s_e0) / p.tile_e + 1;
  // 16-byte pieces: key row j, piece part; thread tid starts at piece tid
  // and strides by THREADS pieces (a carry instead of a divide per piece)
  const int cpr = D * (int)sizeof(KT) / 16;
  const int j0 = tid / cpr, part0 = tid - j0 * cpr;
  const int jstep = THREADS / cpr, pstep = THREADS - jstep * cpr;
  const size_t blk_elems = (size_t)p.Hkv * blk * D;
  const KT* kpool = static_cast<const KT*>(p.k) + (size_t)h * blk * D;
  const KT* vpool = static_cast<const KT*>(p.v) + (size_t)h * blk * D;

  if (MODE == MMA_S8 && k_row_bytes(MODE, D, 1) > D)  // zero the K pad columns
    for (int j = tid; j < 2 * T; j += THREADS)
      *reinterpret_cast<uint4*>(k_s + (j / T) * L.kbuf + (j % T) * L.kstride + D) =
          make_uint4(0, 0, 0, 0);
  for (int e = tid; e < rows_pad * D / 4; e += THREADS)
    reinterpret_cast<float4*>(acc_s)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < rows_pad) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();  // block ids in shared memory

  auto stage = [&](int t, int buf) {
    const int e0 = t * p.tile_e;  // first entry of the tile, from the split's
    unsigned char* kd = k_s + buf * L.kbuf;
    unsigned char* vd = v_s + buf * L.vbuf;
    for (int j = j0, part = part0; j < T; j += jstep, part += pstep) {
      if (part >= cpr) {
        part -= cpr;
        ++j;
        if (j >= T) break;
      }
      const int e = e0 + kent_s[j], i = s_e0 + e;
      const bool ok = j < p.tile_e * blk && i >= e_lo && i < e_hi;
      const size_t off = ok ? (size_t)bid_s[e] * blk_elems + koff_s[j] : 0;
      cp_async16(kd + j * L.kstride + part * 16,
                 reinterpret_cast<const unsigned char*>(kpool + off) + part * 16, ok);
      cp_async16(vd + j * L.vstride + part * 16,
                 reinterpret_cast<const unsigned char*>(vpool + off) + part * 16, ok);
    }
    cp_async_commit();
  };
  stage(t_lo, 0);

  // P·V ownership: thread (slot, dg) holds columns dg·8 .. +8 of rows
  // slot, slot + rpp, ... of the shared accumulators
  const int tpr = D / 8, rpp = THREADS / tpr;
  const int slot = tid / tpr, dg = tid - slot * tpr;
  constexpr int LPR = 8;  // softmax lanes per row

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory

    const int te0 = t * p.tile_e;  // the tile's first entry, from the split's
    const int key_end = (min(e_hi, s_e0 + te0 + p.tile_e) - s_e0 - te0) * blk;
    const int pos0 = st + (s_e0 + te0) * blk;
    auto valid = [&](int r, int j) {
      const int len_r = len + rq_s[r];  // this row's effective length
      const int pos = pos0 + j;
      return j < key_end && pos < len_r && (p.window < 0 || pos >= len_r - p.window);
    };
    const unsigned char* kb = k_s + buf * L.kbuf;

    // masked scores of the chunk's rows against the tile's keys
    if constexpr (MODE == MMA_S8 || MODE == MMA_BF16) {
      using Acc = typename std::conditional<MODE == MMA_S8, int, float>::type;
      const int g = lane >> 2, tg = lane & 3;
      const int ntn = T / 8, n_tiles = (rows_pad / 16) * ntn;
      const int row_bytes = q_row_bytes(MODE, D);
      for (int tt = warp; tt < n_tiles; tt += NWARPS) {
        const int mt = tt / ntn, nt = tt - mt * ntn;
        const unsigned char* qa = q_s + (mt * 16 + g) * L.qstride + tg * 4;
        const unsigned char* ka = kb + (nt * 8 + g) * L.kstride + tg * 4;
        Acc c[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < row_bytes; k0 += 32) {  // 32 bytes of depth per MMA
          const uint32_t a[4] = {ld32(qa + k0), ld32(qa + 8 * L.qstride + k0),
                                 ld32(qa + k0 + 16), ld32(qa + 8 * L.qstride + k0 + 16)};
          const uint32_t bb[2] = {ld32(ka + k0), ld32(ka + k0 + 16)};
          mma(c, a, bb);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = mt * 16 + g + (x >> 1) * 8, j = nt * 8 + tg * 2 + (x & 1);
          float sc = -INFINITY;
          if (valid(r, j)) {
            if constexpr (MODE == MMA_S8)
              sc = (float)c[x] * ks_s[te0 + kent_s[j]];
            else
              sc = c[x] * p.rsd;
          }
          s_s[r * L.sstride + j] = sc;
        }
      }
    } else {
      // two rows × two keys per thread; keys j and j + T/2 keep a warp's
      // 16-byte K loads on distinct banks; each dot runs over d in order
      const int half = T / 2;
      for (int idx = tid; idx < (rows_pad / 2) * half; idx += THREADS) {
        const int rp = idx / half, j1 = idx - rp * half, j2 = j1 + half;
        const float* qa = reinterpret_cast<const float*>(q_s + 2 * rp * L.qstride);
        const float* qb = reinterpret_cast<const float*>(q_s + (2 * rp + 1) * L.qstride);
        const KT* ka = reinterpret_cast<const KT*>(kb + j1 * L.kstride);
        const KT* kc = reinterpret_cast<const KT*>(kb + j2 * L.kstride);
        float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
        for (int d = 0; d < D; d += 8) {
          float x[8], y[8], u[8], w[8];
          ld8(qa + d, x); ld8(qb + d, y); ld8(ka + d, u); ld8(kc + d, w);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s00 = fmaf(x[i], u[i], s00);
            s01 = fmaf(x[i], w[i], s01);
            s10 = fmaf(y[i], u[i], s10);
            s11 = fmaf(y[i], w[i], s11);
          }
        }
        const int r = 2 * rp;
        s_s[r * L.sstride + j1] = valid(r, j1) ? s00 * p.rsd : -INFINITY;
        s_s[r * L.sstride + j2] = valid(r, j2) ? s01 * p.rsd : -INFINITY;
        s_s[(r + 1) * L.sstride + j1] = valid(r + 1, j1) ? s10 * p.rsd : -INFINITY;
        s_s[(r + 1) * L.sstride + j2] = valid(r + 1, j2) ? s11 * p.rsd : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over the tile: 8 lanes per row, lane l takes keys
    // l, l + 8, ... in order, then a 3-level shuffle tree — the same for
    // every row
    {
      const int sub = lane / LPR, l8 = lane % LPR;
      for (int r0w = warp * (32 / LPR); r0w < G; r0w += NWARPS * (32 / LPR)) {
        const int r = r0w + sub;
        const bool live = r < G;
        float* srow = s_s + (live ? r : 0) * L.sstride;
        float mx = -INFINITY;
        for (int j = l8; j < T; j += LPR) mx = fmaxf(mx, srow[j]);
        for (int o = LPR / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = live ? m_s[r] : -INFINITY;
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = l8; j < T; j += LPR) {
          const float sv = srow[j];
          const float pv = sv == -INFINITY ? 0.f : expf(sv - m_new);
          sum += pv;
          if (live) {
            if constexpr (MODE == MMA_S8)  // the block's V scale rides on p
              srow[j] = pv == 0.f ? 0.f : pv * vs_s[te0 + kent_s[j]];
            else
              srow[j] = pv;
          }
        }
        for (int o = LPR / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (live && l8 == 0) {
          const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc·alpha + Σ_j p_j · v_j, keys in order; a thread's rows go
    // four at a time, so each V row is read once for four of them
    if (slot < rpp) {
      const KT* vcol = reinterpret_cast<const KT*>(v_s + buf * L.vbuf) + dg * 8;
      const int mine = slot < G ? (G - slot + rpp - 1) / rpp : 0;
      int k = 0;
      for (; k + 4 <= mine; k += 4)
        pv_rows<4>(acc_s, s_s, a_s, vcol, D, L.sstride, key_end, k * rpp + slot, rpp, dg);
      for (; k < mine; ++k)
        pv_rows<1>(acc_s, s_s, a_s, vcol, D, L.sstride, key_end, k * rpp + slot, rpp, dg);
    }
    __syncthreads();  // buffer `buf` and the scores are free again
  }

  if (n_active == 1) {  // the row's only live split: normalise in place
    for (int e = tid; e < G * D / 8; e += THREADS) {
      const int r = e / (D / 8), c = (e - r * (D / 8)) * 8;
      const float l = l_s[r];
      float a[8];
      ld8(acc_s + r * D + c, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) op[r * D + c + i] = from_f<QT>(l == 0.f ? 0.f : a[i] / l);
    }
    return;
  }

  // partial result of this split → workspace; the last split in combines
  const size_t bh = ((size_t)b * p.Hkv + h) * p.nsplit;
  float* ml = p.ws_ml + ((bh + split) * R + r0) * 2;
  float* wacc = p.ws_acc + ((bh + split) * R + r0) * (size_t)D;
  if (tid < G) reinterpret_cast<float2*>(ml)[tid] = make_float2(m_s[tid], l_s[tid]);
  for (int e = tid; e < G * D / 4; e += THREADS)
    reinterpret_cast<float4*>(wacc)[e] = reinterpret_cast<const float4*>(acc_s)[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(p.ws_count + ((size_t)b * p.Hkv + h) * p.chunks + chunk, 1);
    *flag_s = ticket == n_active - 1;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();

  // combine the live splits in split order: their m, l into the score
  // tile, the weights over m
  float* wm_s = s_s;                          // [n_active][rows_pad]: m, then weight
  float* lp_s = s_s + MAX_SPLITS * rows_pad;  // [n_active][rows_pad]: l
  for (int e = tid; e < n_active * G; e += THREADS) {
    const int sp = e / G, r = e - sp * G;
    const float2 v2 = __ldcg(reinterpret_cast<const float2*>(
        p.ws_ml + ((bh + s_first + sp) * R + r0 + r) * 2));
    wm_s[sp * rows_pad + r] = v2.x;
    lp_s[sp * rows_pad + r] = v2.y;
  }
  __syncthreads();
  for (int r = tid; r < G; r += THREADS) {
    float big = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp) big = fmaxf(big, wm_s[sp * rows_pad + r]);
    float lsum = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {
      const float ms = wm_s[sp * rows_pad + r];
      const float w = ms == -INFINITY ? 0.f : expf(ms - big);
      wm_s[sp * rows_pad + r] = w;
      if (w != 0.f) lsum = fmaf(w, lp_s[sp * rows_pad + r], lsum);
    }
    l_s[r] = lsum;
  }
  __syncthreads();
  const size_t sp_acc = (size_t)R * D;
  for (int e = tid; e < G * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
    const float4* src = reinterpret_cast<const float4*>(
        p.ws_acc + ((bh + s_first) * R + r0 + r) * (size_t)D + c);
    float4 a[MAX_SPLITS];  // every split's partial in flight at once
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_active) a[sp] = __ldcg(src + sp * sp_acc / 4);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp >= n_active) break;
      const float w = wm_s[sp * rows_pad + r];
      if (w == 0.f) continue;
      o[0] = fmaf(w, a[sp].x, o[0]);
      o[1] = fmaf(w, a[sp].y, o[1]);
      o[2] = fmaf(w, a[sp].z, o[2]);
      o[3] = fmaf(w, a[sp].w, o[3]);
    }
    const float l = l_s[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) op[r * D + c + i] = from_f<QT>(l == 0.f ? 0.f : o[i] / l);
  }
}

template <typename QT, typename KT, int MODE>
int launch_typed(Params p, void* ws, long long ws_bytes, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  if (p.Hkv < 1 || G * p.Hkv != p.Hq || p.Q < 1 || p.D % 16 || p.D < 16 ||
      p.D > MAX_D || p.blk < 1 || p.M < 0 || p.tile_e < 1 ||
      p.split_e < p.tile_e || p.split_e % p.tile_e || p.rows < 1 ||
      p.rows > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int R = G * p.Q;
  p.T = align16(p.tile_e * p.blk);
  p.nsplit = p.M > 0 ? (p.M + p.split_e - 1) / p.split_e : 1;
  p.chunks = (R + p.rows - 1) / p.rows;
  if (p.T > MAX_TILE || p.nsplit > MAX_SPLITS || p.rows * p.D > MAX_ACC)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(MODE, (int)sizeof(KT), align16(p.rows), p.D, p.T, p.split_e);
  if (L.bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // workspace: tickets | m, l | accumulators (only a row split in two or
  // more needs it)
  if (p.nsplit > 1) {
    const size_t n_cnt = align4((size_t)p.B * p.Hkv * p.chunks);
    const size_t n_ml = align4((size_t)p.B * p.Hkv * p.nsplit * R * 2);
    const size_t n_acc = (size_t)p.B * p.Hkv * p.nsplit * R * p.D;
    if (!ws || (long long)((n_cnt + n_ml + n_acc) * 4) > ws_bytes)
      return (int)cudaErrorInvalidValue;
    p.ws_count = static_cast<int*>(ws);
    p.ws_ml = static_cast<float*>(ws) + n_cnt;
    p.ws_acc = p.ws_ml + n_ml;
    cudaError_t e = cudaMemsetAsync(p.ws_count, 0, n_cnt * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  auto kernel = paged_attention_kernel<QT, KT, MODE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(p.nsplit, p.Hkv * p.chunks, p.B);
  kernel<<<grid, THREADS, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* table, const void* lens, const void* start,
                   const void* kscale, const void* vscale, void* out, int B,
                   int Hq, int Hkv, int D, int N, int blk, int M, int window,
                   int Q, int rows, int tile_e, int split_e, float rsd,
                   float q_scale, float q_inv) {
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.table = (const int*)table; p.lens = (const int*)lens;
  p.start = (const int*)start;
  p.kscale = (const float*)kscale; p.vscale = (const float*)vscale;
  p.out = out;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.D = D; p.N = N; p.blk = blk; p.M = M;
  p.window = window; p.Q = Q; p.rows = rows;
  p.tile_e = tile_e; p.split_e = split_e;
  p.rsd = rsd; p.q_scale = q_scale; p.q_inv = q_inv;
  return p;
}

int launch_float(const Params& p, int qtype, int kvtype, void* ws,
                 long long ws_bytes, cudaStream_t s) {
  if (qtype == 0 && kvtype == 0)
    return launch_typed<float, float, FMA>(p, ws, ws_bytes, s);
  if (qtype == 0 && kvtype == 1)
    return launch_typed<float, __nv_bfloat16, FMA>(p, ws, ws_bytes, s);
  if (qtype == 1 && kvtype == 0)
    return launch_typed<__nv_bfloat16, float, FMA>(p, ws, ws_bytes, s);
  if (qtype == 1 && kvtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, MMA_BF16>(p, ws, ws_bytes, s);
  return (int)cudaErrorInvalidValue;
}

int launch_int8(const Params& p, int qtype, int kvtype, void* ws,
                long long ws_bytes, cudaStream_t s) {
  if (kvtype != 2 || !p.kscale || !p.vscale) return (int)cudaErrorInvalidValue;
  if (qtype == 0) return launch_typed<float, int8_t, MMA_S8>(p, ws, ws_bytes, s);
  if (qtype == 1) return launch_typed<__nv_bfloat16, int8_t, MMA_S8>(p, ws, ws_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every entry point takes the same arguments. qtype: 0 f32, 1 bf16;
// kvtype: 0 f32, 1 bf16 (float pools), 2 int8 (with per-block kscale/vscale).
// Q: query rows per batch row; rows: folded rows per block; tile_e /
// split_e: table entries per staged tile / per split (ops.split_plan); ws:
// the split workspace (ws_bytes long; null when one split covers the
// table). The decode entry points take Q = 1 (B1, B2), the verify ones
// Q = k + 1 (B4, B5).
#define REPRO_PAGED_ARGS                                                     \
  const void *q, const void *k, const void *v, const void *table,            \
      const void *lens, const void *start, const void *kscale,               \
      const void *vscale, void *out, void *ws, int qtype, int kvtype, int B, \
      int Hq, int Hkv, int D, int N, int blk, int M, int window, int Q,      \
      int rows, int tile_e, int split_e, long long ws_bytes, float rsd,      \
      float q_scale, float q_inv, void *stream
#define REPRO_PAGED_PARAMS                                                   \
  make_params(q, k, v, table, lens, start, kscale, vscale, out, B, Hq, Hkv,  \
              D, N, blk, M, window, Q, rows, tile_e, split_e, rsd, q_scale,  \
              q_inv)

int paged_attention_launch(REPRO_PAGED_ARGS) {
  if (Q != 1) return (int)cudaErrorInvalidValue;
  return launch_float(REPRO_PAGED_PARAMS, qtype, kvtype, ws, ws_bytes,
                      (cudaStream_t)stream);
}

int paged_attention_int8_launch(REPRO_PAGED_ARGS) {
  if (Q != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(REPRO_PAGED_PARAMS, qtype, kvtype, ws, ws_bytes,
                     (cudaStream_t)stream);
}

int paged_attention_verify_launch(REPRO_PAGED_ARGS) {
  return launch_float(REPRO_PAGED_PARAMS, qtype, kvtype, ws, ws_bytes,
                      (cudaStream_t)stream);
}

int paged_attention_verify_int8_launch(REPRO_PAGED_ARGS) {
  return launch_int8(REPRO_PAGED_PARAMS, qtype, kvtype, ws, ws_bytes,
                     (cudaStream_t)stream);
}

}  // extern "C"
