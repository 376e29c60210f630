"""Plain PyTorch version of the int8 GEMM kernel — the bit-exact contract.

Port of ``repro.kernels.int8_gemm.ref.int8_gemm_ref``: int8×int8 → int32
accumulation, + int32 bias, optional ``int_relu``, fixed-point
``requantize`` to int8, optional ``int_gelu_i8``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import ita, quant
from repro_torch.core.quant import int8_matmul_ref


def int8_gemm_ref(
    x_q: torch.Tensor,      # [M, K] int8
    w_q: torch.Tensor,      # [K, N] int8
    bias: torch.Tensor,     # [N] int32
    mult: torch.Tensor,     # [N] int32
    shift: torch.Tensor,    # [N] int32
    activation: str = "none",
    act_scales: Optional[tuple] = None,
) -> torch.Tensor:
    """Reference: int8×int8→int32 + bias + activation + requant → int8."""
    acc = int8_matmul_ref(x_q, w_q) + bias.to(torch.int32)
    if activation == "relu":
        acc = ita.int_relu(acc)
    y = quant.requantize(acc, mult, shift)
    if activation == "gelu":
        in_scale, out_scale = act_scales
        y = ita.int_gelu_i8(y.to(torch.int32), in_scale, out_scale)
    return y
