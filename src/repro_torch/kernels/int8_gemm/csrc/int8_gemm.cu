// W8A8 GEMM with int32 accumulation and the fused ITA epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/int8_gemm/kernel.py, int8_gemm_pallas
//   (body _gemm_kernel): y = requantize(act(x_q @ w_q + bias)) → int8, with
//   an optional int_relu before and int_gelu_i8 after the requantization.
// Contract: bit-exact with repro_torch/kernels/int8_gemm/ref.py, which
//   ports the reference's int32 arithmetic (wrapping, XLA shift semantics).
//
// What bounds it: the main path calls it at decode (M = the serving slots,
//   1..8) and at the speculative verify pass (M = slots × (spec_tokens + 1),
//   40 in chip_smoke.py), with K×N a whole weight matrix. Each weight byte
//   is used M times, so reading the weights once at the card's memory rate
//   bounds it (about 204 MB of int8 weights per glm4-9b layer, 0.061 ms);
//   the products (8.2 G int8 operations per layer at M = 40) take about
//   4 µs on the tensor cores.
// The design:
//   * Swapped operands on the s8 tensor cores. The kernel computes
//     outᵀ[N, M] = W[N, K] · xᵀ with mma.sync m16n8k32 s8·s8→s32: 16 output
//     columns n fill the MMA's rows, 8 token rows m its columns. A block
//     owns 128 output columns (8 warps × 16) and up to 64 rows (8 n8
//     tiles), so every M ≤ 64 lives in one tile and each weight byte is
//     read once per call; a larger M walks its 64-row tiles in the same
//     launch (the weights are then read once per 64 rows).
//   * K-major weights. The MMA takes both operands K-major, so w_q is the
//     transposed view of a contiguous [N, K] tensor (stride (1, K)); the
//     wrapper refuses any other layout and never copies it. x [M, K] is
//     K-major already.
//   * Streamed tiles. A unit is 128 W rows × 128 k bytes (16 KB), fetched
//     by one 2-D TMA copy (a tensor map over W, cached per weight pointer
//     and shape) into a ring of 3 shared-memory stages that signal an
//     mbarrier; 2 units are in flight while one computes. The TMA unit
//     zero-fills rows past N and columns past K and lays rows out with its
//     128-byte swizzle. The tile's x rows × 128 bytes come by 16-byte
//     cp.async (zero-filled past M and K) into the same swizzled layout.
//     K not a multiple of 16 (or an unaligned pointer) takes a byte-wise
//     load into the same stages.
//   * A k permutation instead of ldmatrix. Integer sums are exact and
//     order-free, so any k order that both operands share gives the same
//     result. Lane (g, q) takes the 16-byte chunk 2q + c (c = 0, 1) of its
//     W rows g, g + 8 and its x row g with one shared load each; the four
//     32-bit words feed two consecutive m16n8k32 products. Under the
//     swizzle the eight lanes of a load phase (rows g, g + 1) hit 32
//     distinct banks.
//   * Split K as stream-K. The units of all output tiles (m tile, n tile,
//     k tile; k fastest) are cut into one even run per block, with as many
//     blocks as fit on the card at once, so every SM streams the same
//     number of weight bytes whatever N and K are (wk/wv's 2 n tiles, wd's
//     107 k tiles). A block that holds a whole tile runs the epilogue from
//     its registers. A tile shared by several blocks: each adds its
//     accumulators into the tile's sums in the workspace (atomic adds),
//     fences, and takes a ticket; the last one reads the sums back, zeroes
//     them and the ticket, and runs the epilogue. Int32 sums that wrap are
//     associative, so any split and any order of adding is bit-exact with
//     the plain version.
//   * Workspace across calls. The wrapper allocates the tickets and sums
//     once per (device, stream), zeroed; every launch leaves them zero, so
//     no memset runs per call. Launches on one stream run one after
//     another, so no two launches share the workspace at once.
//   * Epilogue: + bias, int_relu, requantize, int_gelu_i8 from
//     kernels/common/int32.cuh (their branch-free forms, so the four
//     outputs of an unrolled step are in flight together), through a tile
//     in shared memory so a warp stores contiguous bytes, in a loop
//     unrolled only 4 times: a block runs it once per tile from a cold
//     instruction cache, and a fully unrolled epilogue spent most of the
//     kernel's tail fetching its own code (measured with phases.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "../../common/int32.cuh"

namespace {

using namespace int32_ref;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = WARPS * 16;     // output columns (W rows) per tile
constexpr int BK = 128;            // k bytes per unit (the swizzle's span)
constexpr int CPR = BK / 16;       // 16-byte chunks per row of a unit
constexpr int W_BYTES = BN * BK;   // one unit of W: one TMA box
constexpr int MT = 8;              // n8 tiles of token rows per tile
constexpr int BM = MT * 8;         // token rows per tile
constexpr int STAGES = 3;
constexpr int SLD = BN + 4;        // row stride (ints) of the epilogue's tile
constexpr int MAX_DEVICES = 64;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

struct Params {
  const int8_t* x;      // [M, K]
  const int8_t* w;      // [N, K] (w_q's K-major storage)
  const int* bias;
  const int* mult;
  const int* shift;
  int8_t* out;          // [M, N]
  int* tickets;         // [tiles], 0 between launches
  int* sums;            // [tiles, WARPS, jt_cap, 4, 32], 0 between launches
  int M, K, N;
  int n_tiles, k_tiles, jt_cap;
  long long units;
  int act, qb, qc, one, gm, gshift;
};

// the ring of stages, then the epilogue's int32 tile [jt_cap · 8][SLD]
__host__ __device__ constexpr int ring_bytes(int jt_cap) {
  return STAGES * (W_BYTES + jt_cap * 8 * BK);
}
__host__ __device__ constexpr int smem_bytes(int jt_cap) {
  // + 1 KB to align the ring to the swizzle's 1024-byte period
  return ring_bytes(jt_cap) + jt_cap * 8 * SLD * 4 + 1024;
}

// core/ita.py int_gelu_i8 with its host-folded constants
__device__ int int_gelu_i8(int q, int qb, int qc, int one, int gm, int gshift) {
  int sgn = (q > 0) - (q < 0);
  int q_abs = min(abs32(q), -qb);
  int l = add32(q_abs, qb);
  int q_erf = mul32(sgn, add32(mul32(l, l), qc));
  int val = mul32(q, add32(q_erf, one));
  return requantize_sel((int)(0u - (unsigned)val), gm, gshift);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared; ok = false writes 16 zero bytes, reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)));
}
// the one arrival of a phase, expecting `bytes` from the TMA unit
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// the W box at (k0, n0) → shared, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0,
                                         int n0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(k0), "r"(n0), "r"(smem_addr(bar))
      : "memory");
}

// D (16×8) += A (16×32 s8, row) · B (32×8 s8, col); no .satfinite: wraps
__device__ __forceinline__ void mma(int* c, uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `ch` of row `r` in a stage: 128-byte rows
// under the TMA's 128-byte swizzle (chunk index ^= row mod 8)
__device__ __forceinline__ int swz(int r, int ch) {
  return r * BK + ((ch ^ (r & 7)) << 4);
}

struct Tile {
  int m0, n0, jt;
};

__device__ __forceinline__ Tile tile_of(const Params& p, long long tile) {
  const int mt = (int)(tile / p.n_tiles);
  const int nt = (int)(tile - (long long)mt * p.n_tiles);
  return {mt * BM, nt * BN, min(MT, (p.M - mt * BM + 7) >> 3)};
}

// the block whose run of units holds unit u
__device__ __forceinline__ int block_of(long long u, long long units, int G) {
  return (int)(((u + 1) * G - 1) / units);
}

__device__ __forceinline__ long long first_unit(int b, long long units, int G) {
  return (long long)b * units / G;
}

// one 16-byte chunk of a row the byte-wise way (K % 16 != 0 or unaligned)
__device__ __forceinline__ uint4 load_bytes(const int8_t* row, int k, int K,
                                            bool live) {
  uint32_t wd[4] = {0, 0, 0, 0};
  if (live) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < K) wd[i >> 2] |= (uint32_t)(uint8_t)row[k + i] << (8 * (i & 3));
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

template <bool VEC>
__device__ __forceinline__ void load_unit(const Params& p, const CUtensorMap* map,
                                          long long u, uint8_t* sw, uint8_t* sx,
                                          uint64_t* bar, int tid) {
  const long long tile = u / p.k_tiles;
  const int k0 = (int)(u - tile * p.k_tiles) * BK;
  const Tile t = tile_of(p, tile);
  if (VEC) {
    if (tid == 0) {
      bar_expect(bar, W_BYTES);
      tma_load(sw, map, k0, t.n0, bar);
    }
  } else {
    for (int c = tid; c < BN * CPR; c += THREADS) {
      const int r = c / CPR, ch = c % CPR, n = t.n0 + r;
      *reinterpret_cast<uint4*>(sw + swz(r, ch)) =
          load_bytes(p.w + (size_t)n * p.K, k0 + ch * 16, p.K, n < p.N);
    }
  }
  for (int c = tid; c < t.jt * 8 * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR;
    const int m = t.m0 + r, k = k0 + ch * 16;
    if (VEC) {
      const bool ok = m < p.M && k < p.K;
      cp_async16(sx + swz(r, ch), p.x + (ok ? (size_t)m * p.K + k : 0), ok);
    } else {
      *reinterpret_cast<uint4*>(sx + swz(r, ch)) =
          load_bytes(p.x + (size_t)m * p.K, k, p.K, m < p.M);
    }
  }
}

// + bias, relu, requantize, gelu and the store of the tile's live outputs.
// The accumulators go through shared memory ([m][n], rows padded so the
// fragment stores hit distinct banks); then thread t owns column t mod 128
// (its bias and constants loaded once) and every second row, so the byte
// stores of a warp are contiguous. Four outputs a step and no more: the
// block runs it once per tile from a cold instruction cache.
__device__ __forceinline__ void epilogue(const Params& p, const Tile& t,
                                         const int (&acc)[MT][4], int* sacc,
                                         int warp, int g, int q, int tid) {
  __syncthreads();   // the previous tile's epilogue is done with sacc
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j < t.jt)
        sacc[(j * 8 + 2 * q + (e & 1)) * SLD + warp * 16 + g + 8 * (e >> 1)] = acc[j][e];
  __syncthreads();
  const int c = tid % BN, n = t.n0 + c;
  if (n >= p.N) return;
  const int bias = p.bias[n], mult = p.mult[n], shift = p.shift[n];
  const int rows = min(t.jt * 8, p.M - t.m0);
  constexpr int RSTEP = THREADS / BN;   // rows between a thread's outputs
  // four outputs a step: their loads first, then their arithmetic (in
  // flight together), then their stores (a byte store may alias sacc)
#pragma unroll 1
  for (int r0 = tid / BN; r0 < rows; r0 += 4 * RSTEP) {
    int y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u] = r0 + u * RSTEP < rows ? sacc[(r0 + u * RSTEP) * SLD + c] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = add32(y[u], bias);
      y[u] = requantize_sel(p.act == ACT_RELU ? max(s, 0) : s, mult, shift);
    }
    if (p.act == ACT_GELU) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[u] = int_gelu_i8(y[u], p.qb, p.qc, p.one, p.gm, p.gshift);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r0 + u * RSTEP < rows)
        p.out[(size_t)(t.m0 + r0 + u * RSTEP) * p.N + n] = (int8_t)y[u];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const Params p, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage's W box landed
  __shared__ int last_s;
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int G = gridDim.x, b = blockIdx.x;
  const int stage_bytes = W_BYTES + p.jt_cap * 8 * BK;   // a multiple of 1024
  int* sacc = reinterpret_cast<int*>(smem + ring_bytes(p.jt_cap));
  const long long u0 = first_unit(b, p.units, G);
  const int nu = (int)(first_unit(b + 1, p.units, G) - u0);
  if (VEC) {
    if (tid < STAGES) bar_init(&full[tid]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nu)
      load_unit<VEC>(p, &map, u0 + s, smem + s * stage_bytes,
                     smem + s * stage_bytes + W_BYTES, &full[s], tid);
    cp_async_commit();
  }

  int acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  // every row this lane reads (W rows 16·warp + g, + 8; x rows 8j + g) is
  // g mod 8, so one swizzle term serves them all
  const int a_row = (warp * 16 + g) * BK;
  for (int i = 0; i < nu; ++i) {
    cp_async_wait<STAGES - 2>();
    if (VEC) bar_wait(&full[i % STAGES], (i / STAGES) & 1);
    __syncthreads();
    {
      const int nx = i + STAGES - 1;
      if (nx < nu) {
        uint8_t* st = smem + (nx % STAGES) * stage_bytes;
        load_unit<VEC>(p, &map, u0 + nx, st, st + W_BYTES, &full[nx % STAGES], tid);
      }
      cp_async_commit();
    }
    const long long u = u0 + i;
    const long long tile = u / p.k_tiles;
    const int kt = (int)(u - tile * p.k_tiles);
    const Tile t = tile_of(p, tile);

    const uint8_t* sw = smem + (i % STAGES) * stage_bytes;
    const uint8_t* sx = sw + W_BYTES;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = ((2 * q + c) ^ g) << 4;
      const uint4 alo = *reinterpret_cast<const uint4*>(sw + a_row + col);
      const uint4 ahi = *reinterpret_cast<const uint4*>(sw + a_row + 8 * BK + col);
      uint4 bx[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (j < t.jt) bx[j] = *reinterpret_cast<const uint4*>(sx + (j * 8 + g) * BK + col);
      // first halves for every n8 tile, then second halves: back-to-back
      // products go to different accumulators
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (j < t.jt) mma(acc[j], alo.x, ahi.x, alo.y, ahi.y, bx[j].x, bx[j].y);
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (j < t.jt) mma(acc[j], alo.z, ahi.z, alo.w, ahi.w, bx[j].z, bx[j].w);
    }

    if (kt != p.k_tiles - 1 && i != nu - 1) continue;
    // the tile ends here for this block
    const long long tu0 = tile * p.k_tiles, tu1 = tu0 + p.k_tiles;
    if (u0 > tu0 || u0 + nu < tu1) {
      // shared with other blocks: add into the tile's sums, take a ticket;
      // the last one reads the sums back, zeroes them and runs the epilogue
      int* sums = p.sums + ((size_t)tile * WARPS + warp) * p.jt_cap * 128 + lane;
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j < t.jt) atomicAdd(sums + (j * 4 + e) * 32, acc[j][e]);
      const int b_first = block_of(tu0, p.units, G);
      const int b_last = block_of(tu1 - 1, p.units, G);
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int ticket = atomicAdd(p.tickets + tile, 1);
        last_s = ticket == b_last - b_first;
        if (last_s) p.tickets[tile] = 0;   // ready for the next launch
      }
      __syncthreads();
      if (last_s) {
        __threadfence();
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j < t.jt) acc[j][e] = __ldcg(sums + (j * 4 + e) * 32);
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j < t.jt) __stcg(sums + (j * 4 + e) * 32, 0);
        epilogue(p, t, acc, sacc, warp, g, q, tid);
      }
    } else {
      epilogue(p, t, acc, sacc, warp, g, q, tid);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }
  cp_async_wait<0>();
}

// blocks an SM holds (per device and row-tile width) times the device's SMs,
// at most the units
template <bool VEC>
int grid_size(const Params& p, int* G) {
  auto kernel = int8_gemm_kernel<VEC>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(MT)),
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared)};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int sms[MAX_DEVICES];
  static int occ[MAX_DEVICES][MT + 1];
  if (!sms[dev]) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (!occ[dev][p.jt_cap]) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[dev][p.jt_cap], kernel, THREADS, smem_bytes(p.jt_cap));
    if (e != cudaSuccess) return (int)e;
    if (occ[dev][p.jt_cap] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long full = (long long)sms[dev] * occ[dev][p.jt_cap];
  *G = (int)(full < p.units ? full : p.units);
  return 0;
}

// the launch's plan from its sizes; ws = nullptr only sizes it
int make_params(Params* p, int M, int K, int N, void* ws, long long ws_ints) {
  if (M < 1 || K < 0 || N < 1) return (int)cudaErrorInvalidValue;
  p->M = M; p->K = K; p->N = N;
  p->n_tiles = (N + BN - 1) / BN;
  p->k_tiles = K > 0 ? (K + BK - 1) / BK : 1;   // K = 0: one zero-filled unit
  p->jt_cap = ((M < BM ? M : BM) + 7) / 8;
  const long long tiles = (long long)((M + BM - 1) / BM) * p->n_tiles;
  p->units = tiles * p->k_tiles;
  const long long tickets = (tiles + 31) / 32 * 32;
  if (ws) {
    if (ws_ints < tickets + tiles * WARPS * p->jt_cap * 128)
      return (int)cudaErrorInvalidValue;
    p->tickets = (int*)ws;
    p->sums = (int*)ws + tickets;
  }
  return 0;
}

// cuTensorMapEncodeTiled, looked up at run time (libcuda is not linked)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of W ([N, K] bytes, 128 × 128-byte boxes, 128-byte
// swizzle, zero fill out of bounds). It depends on the pointer and the
// shape only, so it is cached by them (a weight is called every step).
int weight_map(const void* w, int N, int K, CUtensorMap* out) {
  struct Entry { const void* w; int N, K; CUtensorMap map; };
  constexpr int SLOTS = 1024;
  static Entry cache[SLOTS];
  static EncodeTiled encode = nullptr;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[((uintptr_t)w >> 8 ^ (uintptr_t)w >> 20) % SLOTS];
  if (e.w == w && e.N == N && e.K == K) {
    *out = e.map;
    return 0;
  }
  if (!encode) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault);
    if (err != cudaSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)w, dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.w = nullptr;
    return (int)cudaErrorInvalidValue;
  }
  e.w = w; e.N = N; e.K = K;
  *out = e.map;
  return 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x [M, K] int8, w [N, K] int8 (w_q's K-major storage), bias/mult/shift
// [N] int32 → out [M, N] int8. ws: ws_ints int32 of workspace, all 0 (and
// left at 0): tickets, then the shared tiles' sums (int8_gemm_workspace_ints).
int int8_gemm_launch(const void* x, const void* w, const void* bias,
                     const void* mult, const void* shift, void* out, void* ws,
                     int M, int K, int N, int act, int qb, int qc, int one,
                     int gm, int gshift, long long ws_ints, void* stream) {
  Params p;
  if (!ws) return (int)cudaErrorInvalidValue;
  int err = make_params(&p, M, K, N, ws, ws_ints);
  if (err) return err;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.bias = (const int*)bias;
  p.mult = (const int*)mult;
  p.shift = (const int*)shift;
  p.out = (int8_t*)out;
  p.act = act; p.qb = qb; p.qc = qc; p.one = one; p.gm = gm; p.gshift = gshift;
  const bool vec = K > 0 && K % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  CUtensorMap map = {};
  if (vec && (err = weight_map(w, N, K, &map))) return err;
  int G = 0;
  err = vec ? grid_size<true>(p, &G) : grid_size<false>(p, &G);
  if (err) return err;
  const int smem = smem_bytes(p.jt_cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    int8_gemm_kernel<true><<<G, THREADS, smem, s>>>(p, map);
  } else {
    int8_gemm_kernel<false><<<G, THREADS, smem, s>>>(p, map);
  }
  return (int)cudaGetLastError();
}

// int32 words of workspace a launch at these sizes needs
long long int8_gemm_workspace_ints(int M, int K, int N) {
  Params p;
  if (make_params(&p, M, K, N, nullptr, 0)) return -1;
  const long long tiles = (long long)((M + BM - 1) / BM) * p.n_tiles;
  return (tiles + 31) / 32 * 32 + tiles * WARPS * p.jt_cap * 128;
}

// blocks of the launch at these sizes (aligned operands; 0 on an error)
int int8_gemm_grid(int M, int K, int N) {
  Params p;
  int G = 0;
  if (make_params(&p, M, K, N, nullptr, 0) || grid_size<true>(p, &G)) return 0;
  return G;
}

}  // extern "C"
