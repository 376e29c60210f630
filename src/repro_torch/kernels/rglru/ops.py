"""Public op: the RG-LRU scan (port of ``repro.kernels.rglru.ops``).

The device decides which version runs, as for every kernel of the port: a
CPU tensor takes the plain version (``ref.rglru_ref``), a CUDA tensor
launches the Hopper kernel (``csrc/rglru.cu``, which replaces the TPU kernel
``repro/kernels/rglru/kernel.py:rglru_pallas``). There is no fallback from
one to the other. Unlike the TPU kernel (``S % 256 == 0``), both versions
take any ``S ≥ 1``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru.ref import rglru_ref

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "rglru",
    build.CudaLibrary(build.KERNELS_DIR / "rglru" / "csrc" / "rglru.cu"),
    "rglru_launch",
    [_C.c_void_p] * 3 + [_C.c_int] * 4 + [_C.c_void_p],
    replaces="src/repro/kernels/rglru/kernel.py:52 rglru_pallas",
))

# u (and the output) dtypes the kernel takes, with their code in the C call
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

CHANS = 16         # channels a block owns (rglru.cu)
STEPS = 64         # rows of a staged tile
STAGES = 4         # depth of its cp.async ring
GROUP = 4          # channels a compute thread owns in its row


class Plan(NamedTuple):
    """One launch of the kernel: a grid of ``blocks`` = (channel blocks,
    batch) of ``threads`` threads, each block walking S in ``tiles`` tiles
    of ``steps`` rows with ``smem`` bytes of shared memory."""
    blocks: tuple
    threads: int
    steps: int
    tiles: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, d: int, u_bytes: int = 2) -> Plan:
    """The launch for log_a / u [b, s, d] (``u_bytes``: 2 for bf16 u and h,
    4 for f32): blocks of ``CHANS`` channels, so one recurrentgemma-9b
    prompt (B = 1, D = 4096) gives 256 blocks, two an SM."""
    raw = STEPS * CHANS * (4 + u_bytes)
    return Plan((-(-d // CHANS), b), STEPS * CHANS // GROUP + 32, STEPS,
                -(-s // STEPS), STAGES, STAGES * raw + 2 * STEPS * CHANS * 8)


def _check_shapes(log_a, u):
    if u.dim() != 3 or log_a.shape != u.shape:
        raise ValueError(f"log_a {tuple(log_a.shape)} / u {tuple(u.shape)} "
                         f"must both be [B, S, D]")
    if u.shape[1] == 0:
        raise ValueError("empty sequence")


def rglru_cuda(log_a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel: ``log_a`` float32, ``u`` float32 or
    bfloat16, both contiguous CUDA tensors; the output is in ``u``'s
    dtype."""
    if u.dtype not in _DTYPES:
        raise ValueError(f"u: expected float32 or bfloat16, got {u.dtype}")
    build.check_cuda("log_a", log_a, torch.float32, u.shape)
    build.check_cuda("u", u, u.dtype)
    bsz, s, d = u.shape
    out = torch.empty_like(u)
    if bsz and d:
        KERNEL.launch(build.ptr(log_a), build.ptr(u), build.ptr(out), bsz, s,
                      d, _DTYPES[u.dtype], build.stream_ptr(u))
    return out


def rglru(log_a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RG-LRU scan: log_a [B, S, D] (≤ 0), u [B, S, D] → h [B, S, D] in
    ``u``'s dtype, computed in float32."""
    _check_shapes(log_a, u)
    if u.device.type == "cpu":
        return rglru_ref(log_a, u)
    if u.device.type == "cuda":
        return rglru_cuda(log_a.float().contiguous(), u.contiguous())
    raise ValueError(f"rglru: no version for device {u.device}")
