"""Public op: the ITA integer softmax (port of
``repro.kernels.int_softmax.ops``).

The device decides which version runs, as for every kernel of the port: a
CPU tensor takes the plain version (``ref.int_softmax_ref``), a CUDA tensor
launches the Hopper kernel (``csrc/int_softmax.cu``, which replaces the TPU
kernel ``repro/kernels/int_softmax/kernel.py:int_softmax_pallas``). There
is no fallback from one to the other. Both take any number of rows (the
TPU kernel's ``R % block_rows == 0`` is a tiling artefact that changes no
result) and rows of 1 to 2²² logits, the reference's int32 headroom.
``plan`` gives the kernel's launch for a shape: which of its two bodies
runs, the persistent grid and the shared memory a block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import ita
from repro_torch.kernels import build
from repro_torch.kernels.int_softmax.ref import int_softmax_ref

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "int_softmax",
    build.CudaLibrary(build.KERNELS_DIR / "int_softmax" / "csrc"
                      / "int_softmax.cu"),
    "int_softmax_launch",
    [_C.c_void_p] * 2 + [_C.c_int] * 7 + [_C.c_void_p],
    replaces="src/repro/kernels/int_softmax/kernel.py:35 int_softmax_pallas",
))

MAX_COLS = 1 << 22  # e ≤ 2^FB per element: a row's int32 sum stays < 2³¹


def _check_cols(c: int) -> None:
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"rows of {c} logits: the integer softmax takes "
                         f"1 to {MAX_COLS}")


# int_softmax.cu's shared-memory layout (the kernel indexes it by the same
# constants; its launch takes the bytes ``plan`` gives)
STAGE_COLS = 8192       # longest row the staged body takes
STAGES = 2              # row slots a warp keeps in shared memory
TABLE_BYTES = 256 * 32 * 4  # E[k] for k = 0..255, one copy a bank
EDGE = 32               # a slot's bytes for its row's unaligned ends
LONG_WARPS = 16         # the long body's block takes one row
STAGED_WARPS = 8        # the staged body's block at most: a row a warp
MIN_WARPS = 4           # the staged body's block at least: its table build
                        # hides under four rows' copies
SMEM_LIMIT = 232448     # shared memory a block can have on sm_90
SMEM_SM = 233472        # an SM's shared memory, 1 KB of it kept a block
THREADS_SM = 2048
SMS = 132               # H100 SXM


class Plan(NamedTuple):
    """One launch: ``blocks`` blocks of ``threads`` threads on the
    ``path`` body ("staged": a warp a row through its ring of ``stages``
    slots; "long": the block a row, read three times), at most
    ``rows_per_block`` rows a block in flight at once, ``threads_per_row``
    threads on each, ``smem`` bytes of shared memory a block."""
    path: str
    blocks: int
    threads: int
    rows_per_block: int
    threads_per_row: int
    stages: int
    smem: int


def _per_sm(threads: int, smem: int) -> int:
    """Blocks an SM holds at once, by its threads and shared memory."""
    return min(THREADS_SM // threads, SMEM_SM // (smem + 1024))


@functools.lru_cache(maxsize=256)
def plan(r: int, c: int) -> Plan:
    """The launch for [r, c] int8 logits. Rows of up to ``STAGE_COLS``
    bytes take the staged body: ``r // SMS`` warps a block, within
    ``MIN_WARPS``..``STAGED_WARPS`` and as shared memory allows. Each block
    builds the 32 KB table, which hides under the first rows' copies only
    with four warps or more, so MobileBERT's 512 rows take 128 blocks of 4
    rather than 171 of 3 that would reach every SM. The grid is no larger
    than the card holds at once, cut so that every warp takes the same
    number of rows, give or take one (Whisper-Tiny's 9000 rows: 3000 warps
    of 3, not 4224 of 2 or 3). Longer rows take a 512-thread block each."""
    _check_cols(c)
    if r < 1:
        raise ValueError(f"{r} rows: the kernel takes at least one")
    if c > STAGE_COLS:
        threads = 32 * LONG_WARPS
        smem = TABLE_BYTES + 2 * LONG_WARPS * 4
        return Plan("long", min(r, SMS * _per_sm(threads, smem)), threads, 1,
                    threads, 0, smem)
    slot = (c // 16) * 16 + EDGE
    warps = min(max(MIN_WARPS, min(STAGED_WARPS, r // SMS)),
                (SMEM_LIMIT - TABLE_BYTES) // (STAGES * slot))
    smem = TABLE_BYTES + warps * STAGES * slot
    resident = SMS * _per_sm(32 * warps, smem) * warps
    rows_a_warp = -(-r // resident)
    blocks = -(-(-(-r // rows_a_warp)) // warps)
    return Plan("staged", blocks, 32 * warps, warps, 32, STAGES, smem)


def int_softmax_cuda(logits_q: torch.Tensor, *, logit_scale: float
                     ) -> torch.Tensor:
    """Launch the Hopper kernel on contiguous int8 CUDA logits [R, C]."""
    if logits_q.dim() != 2:
        raise ValueError(f"logits: expected [R, C], got "
                         f"{tuple(logits_q.shape)}")
    build.check_cuda("logits_q", logits_q, torch.int8)
    r, c = logits_q.shape
    _check_cols(c)
    spec = ita.SoftmaxSpec(logit_scale)
    out = torch.empty((r, c), dtype=torch.uint8, device=logits_q.device)
    if r:
        if build.ptr(logits_q) % 16:  # a view off the 16-byte grid
            logits_q = logits_q.clone()
        p = plan(r, c)
        KERNEL.launch(build.ptr(logits_q), build.ptr(out), r, c,
                      spec.alpha_mult, ita.sra_count(spec.alpha_rshift),
                      p.blocks, p.threads // 32, p.smem,
                      build.stream_ptr(logits_q))
    return out


def int_softmax(logits_q: torch.Tensor, *, logit_scale: float
                ) -> torch.Tensor:
    """Integer softmax over the last axis: int8 [..., C] → uint8 [..., C]."""
    if logits_q.dtype != torch.int8:
        raise ValueError(f"logits: expected torch.int8, got {logits_q.dtype}")
    _check_cols(logits_q.shape[-1] if logits_q.dim() else 0)
    x2 = logits_q.reshape(-1, logits_q.shape[-1])
    if x2.device.type == "cpu":
        y = int_softmax_ref(x2, logit_scale=logit_scale)
    elif x2.device.type == "cuda":
        y = int_softmax_cuda(x2.contiguous(), logit_scale=logit_scale)
    else:
        raise ValueError(f"int_softmax: no version for device {x2.device}")
    return y.reshape(logits_q.shape)
