"""Public ops: paged decode and speculative-verify attention over float
and int8 block pools.

Port of ``repro.kernels.paged_attention.ops`` without the reference's
``xla``/``interpret``/``pallas`` backend ladder: the device decides. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
Hopper kernel in ``csrc/paged_attention.cu``, which replaces the TPU
kernels ``paged_attention_pallas`` (float pools),
``paged_attention_int8_pallas`` (int8 pools) and their small-q verify
counterparts ``paged_attention_verify_pallas`` /
``paged_attention_verify_int8_pallas`` of
``repro/kernels/paged_attention/kernel.py``. There is no fallback from one
to the other.

Layouts are the reference's: q ``[B, Hq, Q, D]`` (``Q = 1`` for decode,
``spec_tokens + 1`` for verify), pools ``[N, Hkv, block_len, D]``, block
table ``[B, M]`` int32, lens and start ``[B]`` int32, per-block scales
``[N]`` f32.

The kernel splits each row's table walk over several blocks (split-KV flash
decoding). ``split_plan`` fixes where — from the table width and the pool
geometry, never from ``Q``, which keeps verify bit-equal to decode — and
``row_chunks`` how many folded query rows one block holds; the wrapper
allocates the splits' workspace (one ``torch.empty``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import recip32
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_int8_dequant_ref, paged_attention_ref,
    paged_attention_verify_int8_dequant_ref, paged_attention_verify_ref,
)
from repro_torch.models.attention import KV_SCALE, Q_SCALE

_C = ctypes
_LIB = build.CudaLibrary(
    build.KERNELS_DIR / "paged_attention" / "csrc" / "paged_attention.cu")
_ARGTYPES = ([_C.c_void_p] * 10 + [_C.c_int] * 14 + [_C.c_longlong]
             + [_C.c_float] * 3 + [_C.c_void_p])
KERNEL = build.register(build.CudaKernel(
    "paged_attention", _LIB, "paged_attention_launch", _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:117 "
             "paged_attention_pallas"))
KERNEL_INT8 = build.register(build.CudaKernel(
    "paged_attention_int8", _LIB, "paged_attention_int8_launch", _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:237 "
             "paged_attention_int8_pallas"))
KERNEL_VERIFY = build.register(build.CudaKernel(
    "paged_attention_verify", _LIB, "paged_attention_verify_launch",
    _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:387 "
             "paged_attention_verify_pallas"))
KERNEL_VERIFY_INT8 = build.register(build.CudaKernel(
    "paged_attention_verify_int8", _LIB, "paged_attention_verify_int8_launch",
    _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:504 "
             "paged_attention_verify_int8_pallas"))

_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KVTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's limits (csrc/paged_attention.cu): at most 112 folded rows a
# block and rows × head_dim ≤ 16384 f32 accumulators (64 KB of shared
# memory); at most 16 splits a row; head_dim a multiple of 16 up to 256
MAX_ROWS, MAX_ACC, MAX_SPLITS, MAX_D = 112, 16384, 16, 256
TILE_KEYS = 64   # keys staged per tile (32 / 16 for key rows ≥ 512 / 1024 B)


@functools.lru_cache(maxsize=None)
def split_plan(m: int, blk: int, d: int, kv_itemsize: int
               ) -> Tuple[int, int, int]:
    """(table entries per staged tile, entries per split, splits per row)
    for a table of width ``m``. A function of the table width and the pool
    geometry only — never of the query rows — so decode and verify split a
    row at the same entries (the kernels' bit-equality rests on it). Each
    split walks at least one tile; a row has at most ``MAX_SPLITS`` splits
    (glm4-9b decode, m = 34–36: 9 splits of 4 entries = 64 keys)."""
    row = d * kv_itemsize   # bytes of one key row
    keys = TILE_KEYS if row < 512 else TILE_KEYS // 2 if row < 1024 \
        else TILE_KEYS // 4
    tile = max(1, keys // blk)
    tiles = max(1, -(-m // tile))
    per_split = -(-tiles // MAX_SPLITS)
    return tile, tile * per_split, -(-tiles // per_split)


@functools.lru_cache(maxsize=None)
def row_chunks(group: int, qlen: int, d: int) -> Tuple[int, int]:
    """(folded query rows per block, row chunks): all G·Q rows of a (row,
    kv head) in one block up to the block's capacity (glm4-9b: decode's 16
    and verify's 80 at k = 4 are one chunk, up to k = 6), else balanced
    chunks."""
    cap = min(MAX_ROWS, MAX_ACC // d) // 16 * 16
    total = group * qlen
    chunks = -(-total // cap)
    return -(-total // chunks), chunks


def launch_grid(q: torch.Tensor, k_pool: torch.Tensor,
                block_table: torch.Tensor) -> Tuple[int, int, int]:
    """The kernel's grid for these inputs: (splits, kv heads × row chunks,
    batch rows)."""
    b, hq, qlen, d = q.shape
    _, hkv, blk, _ = k_pool.shape
    _, _, n_splits = split_plan(block_table.shape[1], blk, d,
                                k_pool.element_size())
    _, chunks = row_chunks(hq // hkv, qlen, d)
    return n_splits, hkv * chunks, b


def _check_shapes(q, k_pool, v_pool, block_table, lens, start, qlen=None):
    """``qlen`` None: verify (any Q ≥ 1); else q must have exactly qlen
    query rows (decode: 1)."""
    if q.dim() != 4 or (qlen is not None and q.shape[2] != qlen) \
            or q.shape[2] < 1:
        want = "Q" if qlen is None else str(qlen)
        raise ValueError(f"q must be [B, Hq, {want}, D], got {tuple(q.shape)}")
    if q.shape[1] % k_pool.shape[1]:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pool.shape[1]}")
    if k_pool.shape != v_pool.shape or k_pool.shape[-1] != q.shape[-1]:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    b = q.shape[0]
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block table must be [{b}, M], got "
                         f"{tuple(block_table.shape)}")
    if tuple(lens.shape) != (b,) or (start is not None
                                     and tuple(start.shape) != (b,)):
        raise ValueError("lens/start must be [B]")


def _launch(kernel, q, k_pool, v_pool, block_table, lens, start, k_scale,
            v_scale, window):
    b, hq, qlen, d = q.shape
    n, hkv, blk, _ = k_pool.shape
    m = block_table.shape[1]
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_D}")
    if q.dtype not in _QTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("q and the pools must start on a 16-byte boundary "
                         "(the kernel copies 16 bytes at a time)")
    build.check_cuda("q", q, q.dtype)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype not in _KVTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not supported")
        build.check_cuda(name, t, k_pool.dtype)
    build.check_cuda("block_table", block_table, torch.int32)
    build.check_cuda("lens", lens, torch.int32)
    if start is not None:
        build.check_cuda("start", start, torch.int32)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None:
            build.check_cuda(name, t, torch.float32, (n,))
    out = torch.empty_like(q)
    if b == 0:
        return out
    tile_e, split_e, n_splits = split_plan(m, blk, d, k_pool.element_size())
    rows, chunks = row_chunks(hq // hkv, qlen, d)
    ws = None
    if n_splits > 1:  # tickets | m, l | accumulators of every split
        r = hq // hkv * qlen
        ws = torch.empty(_align4(b * hkv * chunks)
                         + _align4(b * hkv * n_splits * r * 2)
                         + b * hkv * n_splits * r * d,
                         dtype=torch.float32, device=q.device)
    kernel.launch(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(block_table), build.ptr(lens), build.ptr(start),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(out), build.ptr(ws),
        _QTYPES[q.dtype], _KVTYPES[k_pool.dtype], b, hq, hkv, d, n, blk, m,
        -1 if window is None else int(window), qlen, rows, tile_e, split_e,
        0 if ws is None else 4 * ws.numel(), float(np.float32(d ** -0.5)),
        float(np.float32(Q_SCALE)), recip32(Q_SCALE), build.stream_ptr(q))
    return out


def _align4(x: int) -> int:
    return -(-x // 4) * 4


def _int8_scales(name, q, k_pool, v_pool, k_scale, v_scale):
    """Int8 pool check; missing per-block scales default to ``KV_SCALE``."""
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        other = name.replace("_int8", "")
        raise ValueError(
            f"{name} needs int8 pools, got {k_pool.dtype}/{v_pool.dtype} — "
            f"float pools go through {other}")
    n = k_pool.shape[0]
    if k_scale is None:
        k_scale = torch.full((n,), KV_SCALE, dtype=torch.float32,
                             device=q.device)
    if v_scale is None:
        v_scale = torch.full((n,), KV_SCALE, dtype=torch.float32,
                             device=q.device)
    return k_scale, v_scale


def _is_cuda(name, q) -> bool:
    """True: launch the kernel; False: a CPU tensor takes the plain version."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no version for device {q.device}")
    return q.device.type == "cuda"


def paged_attention(
    q: torch.Tensor,            # [B, Hq, 1, D] float (post-RoPE)
    k_pool: torch.Tensor,       # [N, Hkv, block_len, D]
    v_pool: torch.Tensor,       # [N, Hkv, block_len, D]
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32 valid positions per row
    *,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,  # [B] int32 abs position of entry 0
) -> torch.Tensor:
    """Decode attention over float block pools."""
    _check_shapes(q, k_pool, v_pool, block_table, lens, start, qlen=1)
    if k_pool.dtype == torch.int8:
        raise ValueError("paged_attention needs float pools — int8 pools go "
                         "through paged_attention_int8")
    if not _is_cuda("paged_attention", q):
        return paged_attention_ref(q, k_pool, v_pool, block_table, lens,
                                   window=window, start=start)
    return _launch(KERNEL, q, k_pool, v_pool, block_table, lens, start,
                   None, None, window)


def paged_attention_int8(
    q: torch.Tensor,            # [B, Hq, 1, D] float (post-RoPE)
    k_pool: torch.Tensor,       # [N, Hkv, block_len, D] int8
    v_pool: torch.Tensor,       # [N, Hkv, block_len, D] int8
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32 valid positions per row
    *,
    k_scale: Optional[torch.Tensor] = None,  # [N] f32 per-block (None→KV_SCALE)
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,  # [B] int32 abs position of entry 0
) -> torch.Tensor:
    """Decode attention over int8 block pools with per-block scales."""
    _check_shapes(q, k_pool, v_pool, block_table, lens, start, qlen=1)
    k_scale, v_scale = _int8_scales("paged_attention_int8", q, k_pool,
                                    v_pool, k_scale, v_scale)
    if not _is_cuda("paged_attention_int8", q):
        return paged_attention_int8_dequant_ref(
            q, k_pool, v_pool, block_table, lens, k_scale=k_scale,
            v_scale=v_scale, window=window, start=start)
    return _launch(KERNEL_INT8, q, k_pool, v_pool, block_table, lens, start,
                   k_scale, v_scale, window)


def paged_attention_verify(
    q: torch.Tensor,            # [B, Hq, Q, D] float (post-RoPE), Q = k + 1
    k_pool: torch.Tensor,       # [N, Hkv, block_len, D]
    v_pool: torch.Tensor,       # [N, Hkv, block_len, D]
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32: committed_len + 1
    *,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Small-q verify attention over float pools for speculative decoding:
    query row ``j`` of each batch row attends ``lens + j`` keys. Row 0 is
    exactly a decode step — at ``Q == 1`` this equals ``paged_attention``
    bit for bit, on either device."""
    _check_shapes(q, k_pool, v_pool, block_table, lens, start)
    if k_pool.dtype == torch.int8:
        raise ValueError("paged_attention_verify needs float pools — int8 "
                         "pools go through paged_attention_verify_int8")
    if not _is_cuda("paged_attention_verify", q):
        return paged_attention_verify_ref(q, k_pool, v_pool, block_table,
                                          lens, window=window, start=start)
    return _launch(KERNEL_VERIFY, q, k_pool, v_pool, block_table, lens, start,
                   None, None, window)


def paged_attention_verify_int8(
    q: torch.Tensor,            # [B, Hq, Q, D] float (post-RoPE)
    k_pool: torch.Tensor,       # [N, Hkv, block_len, D] int8
    v_pool: torch.Tensor,       # [N, Hkv, block_len, D] int8
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32: committed_len + 1
    *,
    k_scale: Optional[torch.Tensor] = None,  # [N] f32 per-block (None→KV_SCALE)
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Small-q verify attention over int8 pools with the int8 decode
    numerics (at ``Q == 1`` bit-equal to ``paged_attention_int8``)."""
    _check_shapes(q, k_pool, v_pool, block_table, lens, start)
    k_scale, v_scale = _int8_scales("paged_attention_verify_int8", q, k_pool,
                                    v_pool, k_scale, v_scale)
    if not _is_cuda("paged_attention_verify_int8", q):
        return paged_attention_verify_int8_dequant_ref(
            q, k_pool, v_pool, block_table, lens, k_scale=k_scale,
            v_scale=v_scale, window=window, start=start)
    return _launch(KERNEL_VERIFY_INT8, q, k_pool, v_pool, block_table, lens,
                   start, k_scale, v_scale, window)
