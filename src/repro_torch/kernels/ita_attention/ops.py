"""Public op: the ITA fused int8 attention (port of
``repro.kernels.ita_attention.ops``), with GQA.

The device decides which version runs, as for every kernel of the port: a
CPU tensor takes the plain version (``ref.ita_attention_gqa_ref``: kv heads
repeated to the query heads, as the reference does), a CUDA tensor launches
the Hopper kernel (``csrc/ita_attention.cu``, which replaces the TPU kernel
``repro/kernels/ita_attention/kernel.py:ita_attention_pallas``; it reads kv
head ``h // group`` in place instead of repeating it). There is no fallback
from one to the other. Both refuse what the TPU kernel refuses: query heads
that are not a multiple of the kv heads, and sequence lengths that
``min(block_q, Sq)`` / ``min(block_kv, Skv)`` do not divide.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ita_attention.ref import (
    constants, ita_attention_gqa_ref, tiling,
)

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "ita_attention",
    build.CudaLibrary(build.KERNELS_DIR / "ita_attention" / "csrc"
                      / "ita_attention.cu"),
    "ita_attention_launch",
    [_C.c_void_p] * 4 + [_C.c_int] * 12 + [_C.c_float] + [_C.c_int] * 3
    + [_C.c_void_p],
    replaces="src/repro/kernels/ita_attention/kernel.py:111 "
             "ita_attention_pallas",
))

MAX_BLOCK_KV = 256  # the kernel stages one K and one V tile in shared memory
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448  # shared memory a block can have on sm_90


class Plan(NamedTuple):
    """One launch: ``warps`` warps (4 or 8) a block of 16 query rows each, the
    block's rows ``heads`` query heads of one kv head at ``positions``
    positions each (heads · positions = 16 · warps), ``blocks`` blocks; kv
    tiles padded to ``key_slices`` · 32 keys and D to ``d_slices`` · 32;
    the kernel instance (``kt``, ``dt``) that holds them, with the scores
    packed four to a register when ``packed``; ``stages`` K/V tiles in
    flight and ``smem`` bytes of shared memory a block."""
    warps: int
    heads: int
    positions: int
    blocks: int
    key_slices: int
    d_slices: int
    kt: int
    dt: int
    packed: bool
    stages: int
    smem: int


def _smem(kpad: int, dp: int, stages: int, warps: int) -> int:
    """Bytes of the kernel's ``Geo``: K and raw V rings, V^T with its row
    of ones, and the block's q rows (pitches padded by 16 bytes)."""
    kp, vp = dp + 16, kpad + 16
    return 2 * stages * kpad * kp + (dp + 8) * vp + 16 * warps * kp


@functools.lru_cache(maxsize=256)
def plan(b: int, hq: int, hkv: int, sq: int, d: int, bkv: int) -> Plan:
    """The launch for q [b, hq, sq, d] over kv heads of ``bkv``-key tiles.
    A block's rows share their kv tiles: as many query heads of a GQA group
    as it has warps at the same 16 positions, or fewer heads at more
    positions. 8 warps a block where eight query heads share a kv head
    (glm4-9b: 8 of 16), else 4: a block of fewer warps stages each tile
    for fewer rows. Two K/V stages where they fit in shared memory, else
    one."""
    group = hq // hkv
    warps = 8 if group % 8 == 0 else 4
    heads = max(h for h in (8, 4, 2, 1) if h <= warps and group % h == 0)
    positions = 16 * warps // heads
    blocks = b * hq // heads * -(-sq // positions)
    kpad, dp = -(-bkv // 32) * 32, -(-d // 32) * 32
    kt = 4 if kpad <= 128 else 8
    dt = 4 if dp <= 128 else 8
    stages = 2 if _smem(kpad, dp, 2, warps) <= SMEM_LIMIT else 1
    smem = _smem(kpad, dp, stages, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ita_attention kernel: no plan for block_kv {bkv}, "
                         f"D {d} ({smem} bytes of shared memory)")
    return Plan(warps, heads, positions, blocks, kpad // 32, dp // 32, kt,
                dt, kt == 8 or dt == 8, stages, smem)


def _check(q, k, v, block_q, block_kv):
    """Shapes and types both versions take; returns ``(group, bq, bkv)``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != torch.int8:
            raise ValueError(f"{name}: expected int8 [B, H, S, D], got "
                             f"{t.dtype} {tuple(t.shape)}")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    return (hq // hkv,) + tiling(sq, k.shape[2], block_q, block_kv)


def ita_attention_cuda(q, k, v, *, qk_scale, v_scale, out_scale,
                       causal=False, logit_amax=10.0, block_q=128,
                       block_kv=128):
    """Launch the Hopper kernel: contiguous int8 CUDA tensors q [B, Hq, Sq,
    D], k and v [B, Hkv, Skv, D] → int8 [B, Hq, Sq, D]."""
    group, bq, bkv = _check(q, k, v, block_q, block_kv)
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(name, t, torch.int8)
    b, hq, sq, d = q.shape
    if bkv > MAX_BLOCK_KV or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes block_kv and D up to "
                         f"{MAX_BLOCK_KV}, got {bkv} and {d}")
    qk_mult, qk_shift, am, ar, out_mult = constants(
        qk_scale, v_scale, out_scale, logit_amax)
    out = torch.empty_like(q)
    if q.numel():
        p = plan(b, hq, k.shape[1], sq, d, bkv)
        KERNEL.launch(build.ptr(q), build.ptr(k), build.ptr(v),
                      build.ptr(out), b * hq, group, sq, k.shape[2], d, bq,
                      bkv, int(causal), qk_mult, qk_shift, am, ar, out_mult,
                      p.warps, p.heads, p.stages, build.stream_ptr(q))
    return out


def ita_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D] int8
    k: torch.Tensor,  # [B, Hkv, Skv, D] int8
    v: torch.Tensor,  # [B, Hkv, Skv, D] int8
    *,
    qk_scale: float,
    v_scale: float,
    out_scale: float,
    causal: bool = False,
    logit_amax: float = 10.0,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """ITA fused int8 attention: int8 [B, Hq, Sq, D] over kv heads shared
    by ``Hq // Hkv`` query heads each → int8 [B, Hq, Sq, D]."""
    kw = dict(qk_scale=qk_scale, v_scale=v_scale, out_scale=out_scale,
              causal=causal, logit_amax=logit_amax, block_q=block_q,
              block_kv=block_kv)
    if q.device.type == "cuda":
        return ita_attention_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous(), **kw)
    if q.device.type != "cpu":
        raise ValueError(f"ita_attention: no version for device {q.device}")
    _check(q, k, v, block_q, block_kv)
    return ita_attention_gqa_ref(q, k, v, **kw)
