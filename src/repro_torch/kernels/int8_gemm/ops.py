"""Public op: quantized linear layer (port of ``repro.kernels.int8_gemm.ops``).

The device decides which version runs: a CPU tensor takes the plain
version (``ref.int8_gemm_ref``), a CUDA tensor launches the Hopper kernel
(``csrc/int8_gemm.cu``, which replaces the TPU kernel
``repro/kernels/int8_gemm/kernel.py:int8_gemm_pallas``). The two agree bit
for bit; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core import ita, quant
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "int8_gemm",
    build.CudaLibrary(build.KERNELS_DIR / "int8_gemm" / "csrc" / "int8_gemm.cu"),
    "int8_gemm_launch",
    [_C.c_void_p] * 6 + [_C.c_int] * 9 + [_C.c_void_p],
    replaces="src/repro/kernels/int8_gemm/kernel.py:72 int8_gemm_pallas",
))

ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2}


@dataclasses.dataclass(frozen=True)
class QuantizedLinearParams:
    """Static-quantized weights + requant constants for one linear layer.

    Fields may carry a leading stack axis (one entry per layer), like the
    reference's vmapped tree.
    """

    w_q: torch.Tensor      # [K, N] int8
    bias: torch.Tensor     # [N] int32 (bias folded to accumulator scale)
    mult: torch.Tensor     # [N] int32
    shift: torch.Tensor    # [N] int32

    @classmethod
    def from_float(cls, w, bias_f, in_scale: float, out_scale: float):
        w_q, w_scale = quant.quantize_weights(w)          # per-out-channel
        acc_scale = w_scale * in_scale                    # int32 acc scale
        bias_q = torch.round(bias_f / acc_scale).to(torch.int32)
        mult, shift = quant.quantize_to_fixed_point(acc_scale / out_scale)
        return cls(w_q=w_q, bias=bias_q, mult=mult, shift=shift)

    def __getitem__(self, i) -> "QuantizedLinearParams":
        """One stack entry (layer ``i``) of a stacked tree."""
        return QuantizedLinearParams(self.w_q[i], self.bias[i], self.mult[i],
                                     self.shift[i])


def int8_gemm_cuda(x_q, w_q, bias, mult, shift, *, activation="none",
                   act_scales=None) -> torch.Tensor:
    """Launch the Hopper kernel: [M, K] int8 × [K, N] int8 → [M, N] int8."""
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} × {tuple(w_q.shape)} "
                         f"do not chain")
    m, k = x_q.shape
    n = w_q.shape[1]
    build.check_cuda("x_q", x_q, torch.int8)
    build.check_cuda("w_q", w_q, torch.int8)
    for name, t in (("bias", bias), ("mult", mult), ("shift", shift)):
        build.check_cuda(name, t, torch.int32, (n,))
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    gelu = (0, 0, 0, 0, 0)
    if activation == "gelu":
        gelu = ita.gelu_constants(*act_scales)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    if m == 0 or n == 0:
        return out
    KERNEL.launch(build.ptr(x_q), build.ptr(w_q), build.ptr(bias),
                  build.ptr(mult), build.ptr(shift), build.ptr(out),
                  m, k, n, ACTIVATIONS[activation], *gelu,
                  build.stream_ptr(x_q))
    return out


def int8_gemm(
    x_q: torch.Tensor,
    params: QuantizedLinearParams,
    *,
    activation: str = "none",
    act_scales: Optional[tuple] = None,
) -> torch.Tensor:
    """[..., K] int8 → [..., N] int8 quantized linear."""
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    args = (x2, params.w_q, params.bias, params.mult, params.shift)
    if x2.device.type == "cpu":
        y = int8_gemm_ref(*args, activation=activation, act_scales=act_scales)
    elif x2.device.type == "cuda":
        y = int8_gemm_cuda(*(a.contiguous() for a in args),
                           activation=activation, act_scales=act_scales)
    else:
        raise ValueError(f"int8_gemm: no version for device {x2.device}")
    return y.reshape(*lead, -1)
