"""Public ops: paged decode attention over float and int8 block pools.

Port of ``repro.kernels.paged_attention.ops`` without the reference's
``xla``/``interpret``/``pallas`` backend ladder: the device decides. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
Hopper kernel in ``csrc/paged_attention.cu``, which replaces the TPU
kernels ``paged_attention_pallas`` (float pools) and
``paged_attention_int8_pallas`` (int8 pools) of
``repro/kernels/paged_attention/kernel.py``. There is no fallback from one
to the other.

Layouts are the reference's: q ``[B, Hq, 1, D]``, pools ``[N, Hkv,
block_len, D]``, block table ``[B, M]`` int32, lens and start ``[B]``
int32, per-block scales ``[N]`` f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quant import recip32
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_int8_dequant_ref, paged_attention_ref,
)
from repro_torch.models.attention import KV_SCALE, Q_SCALE

_C = ctypes
_LIB = build.CudaLibrary(
    build.KERNELS_DIR / "paged_attention" / "csrc" / "paged_attention.cu")
_ARGTYPES = ([_C.c_void_p] * 9 + [_C.c_int] * 10 + [_C.c_float] * 3
             + [_C.c_void_p])
KERNEL = build.register(build.CudaKernel(
    "paged_attention", _LIB, "paged_attention_launch", _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:117 "
             "paged_attention_pallas"))
KERNEL_INT8 = build.register(build.CudaKernel(
    "paged_attention_int8", _LIB, "paged_attention_int8_launch", _ARGTYPES,
    replaces="src/repro/kernels/paged_attention/kernel.py:237 "
             "paged_attention_int8_pallas"))

_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KVTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# one block per (row, kv head) holds the GQA group's accumulators in
# registers: at most 16 per thread of its 256 threads
MAX_GROUP_ELEMS = 16 * 256


def _check_shapes(q, k_pool, v_pool, block_table, lens, start):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, Hq, 1, D], got {tuple(q.shape)}")
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
    b, hq, _, d = q.shape
    n, hkv, blk, _ = k_pool.shape
    if (hq // hkv) * d > MAX_GROUP_ELEMS:
        raise ValueError(f"GQA group × head_dim = {(hq // hkv) * d} exceeds "
                         f"{MAX_GROUP_ELEMS}")
    if q.dtype not in _QTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported")
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
    kernel.launch(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(block_table), build.ptr(lens), build.ptr(start),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(out),
        _QTYPES[q.dtype], _KVTYPES[k_pool.dtype], b, hq, hkv, d, n, blk,
        block_table.shape[1], -1 if window is None else int(window),
        float(np.float32(d ** -0.5)), float(np.float32(Q_SCALE)),
        recip32(Q_SCALE), build.stream_ptr(q))
    return out


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
    _check_shapes(q, k_pool, v_pool, block_table, lens, start)
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
    _check_shapes(q, k_pool, v_pool, block_table, lens, start)
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(
            f"paged_attention_int8 needs int8 pools, got "
            f"{k_pool.dtype}/{v_pool.dtype} — float pools go through "
            f"paged_attention")
    n = k_pool.shape[0]
    if k_scale is None:
        k_scale = torch.full((n,), KV_SCALE, dtype=torch.float32,
                             device=q.device)
    if v_scale is None:
        v_scale = torch.full((n,), KV_SCALE, dtype=torch.float32,
                             device=q.device)
    if not _is_cuda("paged_attention_int8", q):
        return paged_attention_int8_dequant_ref(
            q, k_pool, v_pool, block_table, lens, k_scale=k_scale,
            v_scale=v_scale, window=window, start=start)
    return _launch(KERNEL_INT8, q, k_pool, v_pool, block_table, lens, start,
                   k_scale, v_scale, window)
