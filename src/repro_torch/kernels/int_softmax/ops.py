"""Public op: the ITA integer softmax (port of
``repro.kernels.int_softmax.ops``).

The device decides which version runs, as for every kernel of the port: a
CPU tensor takes the plain version (``ref.int_softmax_ref``), a CUDA tensor
launches the Hopper kernel (``csrc/int_softmax.cu``, which replaces the TPU
kernel ``repro/kernels/int_softmax/kernel.py:int_softmax_pallas``). There
is no fallback from one to the other. Both take any number of rows (the
TPU kernel's ``R % block_rows == 0`` is a tiling artefact that changes no
result) and rows of 1 to 2²² logits, the reference's int32 headroom.
"""

from __future__ import annotations

import ctypes

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
    [_C.c_void_p] * 2 + [_C.c_int] * 4 + [_C.c_void_p],
    replaces="src/repro/kernels/int_softmax/kernel.py:35 int_softmax_pallas",
))

MAX_COLS = 1 << 22  # e ≤ 2^FB per element: a row's int32 sum stays < 2³¹


def _check_cols(c: int) -> None:
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"rows of {c} logits: the integer softmax takes "
                         f"1 to {MAX_COLS}")


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
        KERNEL.launch(build.ptr(logits_q), build.ptr(out), r, c,
                      spec.alpha_mult, ita.sra_count(spec.alpha_rshift),
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
