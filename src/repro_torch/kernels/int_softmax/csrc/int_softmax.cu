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
//   holds). x and out are 16-byte aligned (the wrapper copies a view that is
//   not).
//
// What bounds it: the bytes. It reads C bytes and writes C bytes a row. The
//   staged body's loops run about 8.2 integer instructions a logit besides
//   its shared loads (max 0.6: a VIMNMX3 and a shift a word; sum 2.6: PRMT,
//   address, add; probabilities 5.0: PRMT, address, e * 255 + den / 2,
//   multiply-high, packing; counted in `cuobjdump -sass` of the built
//   library), at the INT32 lanes' 16.75 TOP/s: 5.5 us at DINOv2-S's
//   per-layer logits ([6 x 1370, 1370]), under the 22.5 MB at 3.35 TB/s,
//   6.7 us. (The first body's 17 operations a logit, priced the same way,
//   gave 11.4 us; its loops ran about 50 instructions a logit.)
// What the design does about it:
//   - e depends only on k = m - x in [0, 255] and the launch's (mult,
//     rshift), so each block tabulates E[k] once, from int32.cuh's
//     exp2_fixed (the reference's values by construction), in 32 copies:
//     copy c sits in bank c, so a warp's 32 lookups never conflict.
//     E[m - x] is one shared load, x * 128 bytes below table + (m * 32 +
//     lane) * 4.
//   - p = floor(n / den), n = e * 255 + den / 2, is umulhi(c, n) >> sh for
//     a per-row c = ceil(2^F / den) < 2^32 (exact: see div_by; one double
//     division a row), so no element divides. In the staged body sh is a
//     multiple of 8 and the packing PRMT picks the quotient's byte.
//     den >= 256 always (the maximum has k = 0, E[0] = 256), so the
//     reference's max(den, 1) never binds.
//   - The max runs over 16-bit lanes with Hopper's 3-input VIMNMX3 (two
//     instructions a word), the sums reduce with REDUX.
//   - Rows of up to STAGE_COLS bytes (the staged body): one warp a row. The
//     grid is what the card holds at once, and each warp walks rows gw,
//     gw + W, ... (as many a warp as ops.plan's balance gives). Each warp
//     keeps a ring of STAGES row slots in shared memory and starts the copy
//     of its next row before it works on the current one (a deeper ring
//     measured slower: more of the input in flight before any row is
//     done). A row's 16-byte-aligned interior comes by 16-byte cp.async;
//     its unaligned ends (at most 15 bytes each: C = 1370 rows are 2-byte
//     aligned) come as single bytes, one a lane, kept beside the slot. Lane
//     l copies chunks l, l + 32, ... and is the only lane that reads them,
//     so the ring needs no barrier. The three passes (max, sum,
//     probabilities) read the slot; the probabilities go from registers to
//     device memory in 16-byte stores (the ends as bytes). Device memory
//     sees each logit byte and each probability byte once.
//   - Longer rows (the long body): one 512-thread block a row, the same
//     table and division, block reductions through shared memory, and the
//     row read three times by 16-byte loads straight into registers (no
//     thread reads a byte another thread loaded, so a shared-memory ring
//     would only add a copy). A row of up to a few MB stays in L2 between
//     the passes; device memory sees it once while the rows in flight fit
//     the 50 MB L2.
//   ops.plan picks the body, warps a block, the grid and the shared bytes
//   (the table, then each warp's ring of STAGES slots of C rounded down to
//   16 bytes plus EDGE, or the long body's reductions): the launch takes
//   them as given.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/int32.cuh"

namespace {

using namespace int32_ref;

constexpr int PROB_MAX = 255;
constexpr int KEYS = 256;                   // k = m - x in [0, 255]
constexpr int COPIES = 32;                  // table copies, one a bank
constexpr int TABLE_BYTES = KEYS * COPIES * 4;
constexpr int STAGE_COLS = 8192;            // longest row the staged body takes
constexpr int STAGES = 2;                   // row slots a warp keeps
constexpr int EDGE = 32;                    // a slot's bytes for the row's ends
constexpr int MAX_WARPS = 16;
constexpr int MAX_SMEM = 232448;            // shared memory a block may have

// A row's bytes [off, off + C) in x and out: `head` bytes up to a 16-byte
// boundary, `chunks` aligned 16-byte chunks, `tail` bytes after them.
struct Row {
  long long off;
  int head, chunks, tail;
};

__device__ __forceinline__ Row row_at(long long r, int C) {
  Row g;
  g.off = r * C;
  g.head = min((int)((16 - (g.off & 15)) & 15), C);
  g.chunks = (C - g.head) >> 4;
  g.tail = C - g.head - (g.chunks << 4);
  return g;
}

// the column lane `lane` holds of the row's unaligned ends, or -1: lanes
// 0..14 the head, lanes 16..30 the tail
__device__ __forceinline__ int edge_col(const Row& g, int lane) {
  if (lane < g.head) return lane;
  if (lane >= 16 && lane - 16 < g.tail)
    return g.head + (g.chunks << 4) + lane - 16;
  return -1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte b of w, sign-extended: one PRMT (its selector's high bit copies the
// byte's sign; __byte_perm drops that bit)
template <int B> __device__ __forceinline__ int sbyte(uint32_t w) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(w), "r"(0u), "n"(B | (0x888 | B * 0x111) << 4));
  return r;
}

// the running maximum of a chunk's bytes as two signed 16-bit lanes (DPX
// VIMNMX3): w's lanes order by their high bytes (bytes 1 and 3), w << 8's by
// bytes 0 and 2, so the lanes' high bytes carry the maximum byte
__device__ __forceinline__ uint32_t max_chunk(uint32_t acc, uint4 v) {
  acc = __vimax3_s16x2(acc, v.x, v.x << 8);
  acc = __vimax3_s16x2(acc, v.y, v.y << 8);
  acc = __vimax3_s16x2(acc, v.z, v.z << 8);
  return __vimax3_s16x2(acc, v.w, v.w << 8);
}
constexpr uint32_t MAX_INIT = 0x80008000u;   // two lanes of -128 * 256

__device__ __forceinline__ int max_of(uint32_t acc) {
  return max(sbyte<1>(acc), sbyte<3>(acc));
}

// tlb = table + (m * COPIES + lane) * 4 bytes, so E[m - x] sits x * 128
// bytes below it: one multiply-add and a shared load a logit
__device__ __forceinline__ int e_of(const char* tlb, int x) {
  return *reinterpret_cast<const int*>(tlb - x * (COPIES * 4));
}

__device__ __forceinline__ int sum_word(uint32_t w, const char* tlb) {
  return (e_of(tlb, sbyte<0>(w)) + e_of(tlb, sbyte<1>(w))) +
         (e_of(tlb, sbyte<2>(w)) + e_of(tlb, sbyte<3>(w)));
}
__device__ __forceinline__ int sum_chunk(uint4 v, const char* tlb) {
  return (sum_word(v.x, tlb) + sum_word(v.y, tlb)) +
         (sum_word(v.z, tlb) + sum_word(v.w, tlb));
}

// n / den = (n * c) >> F = umulhi(c, n) >> sh for every n the row forms,
// with c = ceil(2^F / den) < 2^32. den > 2^(L-1) and n = e * 255 + den / 2
// < 2^max(18, L), so F in [max(32, max(18, L) + L), 31 + L] is exact
// (Granlund and Montgomery; Lemire, Kaser and Kurz); F = 31 + L is exact for
// every n < 2^31. The smallest such F with sh = F - 32 a multiple of 8 puts
// the quotient in byte sh / 8 of umulhi(c, n): every row of up to 2^20
// logits (den <= 2^28) has one, the staged body's always.
struct Div {
  uint32_t half, c;
  int sh;
  uint32_t sel;   // __byte_perm selector of byte sh / 8 of two words
};

__device__ __forceinline__ Div div_by(int den) {
  const int L = 32 - __clz(den - 1);            // den >= 256: L >= 8
  const int lo = max(32, max(18, L) + L);
  int F = 32 + ((lo - 32 + 7) & ~7);
  if (F > 31 + L) F = 31 + L;
  const double two_f = __hiloint2double((1023 + F) << 20, 0);  // 2^F
  const uint32_t c = __double2uint_ru(__ddiv_ru(two_f, (double)den));
  const uint32_t b = (uint32_t)(F - 32) >> 3;
  return {(uint32_t)den >> 1, c, F - 32, b | (b + 4) << 4};
}

__device__ __forceinline__ uint32_t quotient(int e, const Div& d) {
  return __umulhi(d.c, (uint32_t)e * PROB_MAX + d.half) >> d.sh;
}

// four probabilities packed into a word; BYTES: the row's sh is a multiple
// of 8 and PRMT takes the quotients' bytes without a shift
template <bool BYTES>
__device__ __forceinline__ uint32_t prob_word(uint32_t w, const char* tlb,
                                              const Div& d) {
  uint32_t u[4];
  u[0] = __umulhi(d.c, (uint32_t)e_of(tlb, sbyte<0>(w)) * PROB_MAX + d.half);
  u[1] = __umulhi(d.c, (uint32_t)e_of(tlb, sbyte<1>(w)) * PROB_MAX + d.half);
  u[2] = __umulhi(d.c, (uint32_t)e_of(tlb, sbyte<2>(w)) * PROB_MAX + d.half);
  u[3] = __umulhi(d.c, (uint32_t)e_of(tlb, sbyte<3>(w)) * PROB_MAX + d.half);
  uint32_t sel = d.sel;
  if (!BYTES) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] >>= d.sh;
    sel = 0x40;
  }
  return __byte_perm(__byte_perm(u[0], u[1], sel),
                     __byte_perm(u[2], u[3], sel), 0x5410);
}
template <bool BYTES>
__device__ __forceinline__ uint4 prob_chunk(uint4 v, const char* tlb,
                                            const Div& d) {
  return make_uint4(prob_word<BYTES>(v.x, tlb, d),
                    prob_word<BYTES>(v.y, tlb, d),
                    prob_word<BYTES>(v.z, tlb, d),
                    prob_word<BYTES>(v.w, tlb, d));
}

// table[k * COPIES + c] = E[k] for every copy c: each warp computes 32 keys
// a lane each; a 16-byte store then fills four copies, so each pass of 32
// lanes writes the 32 copies of 4 keys (512 contiguous bytes)
__device__ void build_table(int* table, int mult, int rshift) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k0 = (threadIdx.x >> 5) * 32; k0 < KEYS; k0 += warps * 32) {
    const int e = exp2_fixed(max((-(k0 + lane) * mult) >> rshift, NEG_T));
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      const int v = __shfl_sync(0xffffffffu, e, j + (lane >> 3));
      reinterpret_cast<int4*>(table + (k0 + j) * COPIES)[lane] =
          make_int4(v, v, v, v);
    }
  }
}

// Rows of up to STAGE_COLS bytes: one warp a row through its ring of slots.
__device__ void staged_rows(const int8_t* __restrict__ x,
                            uint8_t* __restrict__ out, int R, int C,
                            int mult, int rshift, unsigned char* smem) {
  int* table = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int body = (C >> 4) << 4;            // a slot's chunk bytes
  const int slot_bytes = body + EDGE;
  unsigned char* ring =
      smem + TABLE_BYTES + (size_t)(threadIdx.x >> 5) * STAGES * slot_bytes;
  const long long first = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * warps;
  const int n = first < R ? (int)((R - 1 - first) / stride + 1) : 0;

  // start row i's copy into its slot (one commit group, empty past the
  // warp's rows); returns the end byte this lane holds, if any
  auto fetch = [&](int i) -> int {
    int v = 0;
    if (i < n) {
      const Row g = row_at(first + i * stride, C);
      unsigned char* slot = ring + (i % STAGES) * slot_bytes;
      const int8_t* src = x + g.off + g.head;
      for (int j = lane; j < g.chunks; j += 32)
        cp_async16(slot + 16 * j, src + 16 * j);
      const int c = edge_col(g, lane);
      if (c >= 0) v = x[g.off + c];
    }
    cp_async_commit();
    return v;
  };
  auto keep_edge = [&](int i, int v) {
    ring[(i % STAGES) * slot_bytes + body + lane] = (unsigned char)v;
  };

  int ahead[STAGES - 1];
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) ahead[i] = fetch(i);
  build_table(table, mult, rshift);          // while the first rows land
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) keep_edge(i, ahead[i]);
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int pending = fetch(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const Row g = row_at(first + i * stride, C);
    const unsigned char* slot = ring + (i % STAGES) * slot_bytes;
    const uint4* ch = reinterpret_cast<const uint4*>(slot);
    const int c = edge_col(g, lane);
    const int xe = c >= 0 ? (int)(int8_t)slot[body + lane] : -128;

    uint32_t acc = MAX_INIT;
    for (int j = lane; j < g.chunks; j += 32) acc = max_chunk(acc, ch[j]);
    const int m = __reduce_max_sync(~0u, max(max_of(acc), xe));
    const char* tlb = reinterpret_cast<const char*>(table + m * COPIES + lane);

    int s = c >= 0 ? e_of(tlb, xe) : 0;
    for (int j = lane; j < g.chunks; j += 32) s += sum_chunk(ch[j], tlb);
    const Div d = div_by(__reduce_add_sync(~0u, s));   // den <= 2^21: sh % 8 == 0

    uint8_t* o = out + g.off;
    uint4* oc = reinterpret_cast<uint4*>(o + g.head);
    for (int j = lane; j < g.chunks; j += 32)
      oc[j] = prob_chunk<true>(ch[j], tlb, d);
    if (c >= 0) o[c] = (uint8_t)quotient(e_of(tlb, xe), d);

    if (i + STAGES - 1 < n) keep_edge(i + STAGES - 1, pending);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = __reduce_max_sync(~0u, v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return __reduce_max_sync(
      ~0u, lane < (int)(blockDim.x >> 5) ? red[lane] : -128);
}
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = __reduce_add_sync(~0u, v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return __reduce_add_sync(~0u, lane < (int)(blockDim.x >> 5) ? red[lane] : 0);
}

// Rows longer than STAGE_COLS: one block a row, three passes over it.
// red_max and red_sum alternate, so two barriers a row keep them apart.
__device__ void long_rows(const int8_t* __restrict__ x,
                          uint8_t* __restrict__ out, int R, int C,
                          unsigned char* smem) {
  const int* table = reinterpret_cast<const int*>(smem);
  int* red_max = reinterpret_cast<int*>(smem + TABLE_BYTES);
  int* red_sum = red_max + MAX_WARPS;
  const int lane = threadIdx.x & 31;
  const int T = blockDim.x;
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const Row g = row_at(r, C);
    const uint4* xc = reinterpret_cast<const uint4*>(x + g.off + g.head);
    const int c = threadIdx.x < 32 ? edge_col(g, lane) : -1;
    const int xe = c >= 0 ? (int)x[g.off + c] : -128;

    uint32_t acc = MAX_INIT;
#pragma unroll 4
    for (int j = threadIdx.x; j < g.chunks; j += T)
      acc = max_chunk(acc, __ldg(xc + j));
    const int m = block_max(max(max_of(acc), xe), red_max);
    const char* tlb = reinterpret_cast<const char*>(table + m * COPIES + lane);

    int s = c >= 0 ? e_of(tlb, xe) : 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < g.chunks; j += T)
      s += sum_chunk(__ldg(xc + j), tlb);
    const Div d = div_by(block_sum(s, red_sum));

    uint8_t* o = out + g.off;
    uint4* oc = reinterpret_cast<uint4*>(o + g.head);
#pragma unroll 4
    for (int j = threadIdx.x; j < g.chunks; j += T)
      oc[j] = prob_chunk<false>(__ldg(xc + j), tlb, d);
    if (c >= 0) o[c] = (uint8_t)quotient(e_of(tlb, xe), d);
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
int_softmax_kernel(const int8_t* __restrict__ x, uint8_t* __restrict__ out,
                   int R, int C, int mult, int rshift) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (C <= STAGE_COLS) {                     // the body follows the shape
    staged_rows(x, out, R, C, mult, rshift, smem);
  } else {
    build_table(reinterpret_cast<int*>(smem), mult, rshift);
    __syncthreads();
    long_rows(x, out, R, C, smem);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x [R, C] int8 → out [R, C] uint8, both 16-byte aligned. Requires R >= 1,
// 1 <= C <= 2^22 and 0 <= rshift <= 31; `blocks`, `warps` and `smem`
// (shared bytes a block) come from ops.plan (warps a block: one a row when
// C <= STAGE_COLS, else the block takes a row).
int int_softmax_launch(const void* x, void* out, int R, int C, int mult,
                       int rshift, int blocks, int warps, int smem,
                       void* stream) {
  if (R < 1 || C < 1 || C > (1 << 22) || rshift < 0 || rshift > 31 ||
      blocks < 1 || warps < 1 || warps > MAX_WARPS || smem < TABLE_BYTES ||
      smem > MAX_SMEM || (((uintptr_t)x | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(int_softmax_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM),
      cudaFuncSetAttribute(int_softmax_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared)};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  int_softmax_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (uint8_t*)out, R, C, mult, rshift);
  return (int)cudaGetLastError();
}

}  // extern "C"
