"""Integer GELU / ReLU — the per-PE activation unit of CHIMERA's TAC.

Port of the activation half of ``repro.core.ita`` (I-BERT-style integer
erf/GELU in int32 arithmetic). These are the int8 GEMM epilogue's
activations; ``gelu_constants`` folds every float-derived constant into
Python ints once, which is how the CUDA epilogue receives them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_ERF_A = -0.2888
_ERF_B = -1.769
_ERF_C = 1.0
# int32 safety: qc = c/(a·s²) and the q·(q_erf+one) product must stay <2³¹.
MIN_GELU_SCALE = 0.008


def _erf_constants(scale: float) -> Tuple[int, int, float]:
    """(qb, qc, value scale) of ``int_erf`` at input scale ``scale``."""
    scale = max(scale, MIN_GELU_SCALE / math.sqrt(2.0))
    qb = int(math.floor(_ERF_B / scale))  # b/s (negative)
    qc = int(math.floor(_ERF_C / (_ERF_A * scale * scale)))
    return qb, qc, _ERF_A * scale * scale


def int_erf(q: torch.Tensor, scale: float):
    """I-BERT integer erf: sgn(q)·[a·(clip(|q|)+b)² + c] in int32 arith."""
    qb, qc, s_out = _erf_constants(scale)
    sgn = torch.sign(q).to(torch.int32)
    q_abs = torch.clamp(q.abs().to(torch.int32), max=-qb)
    l = q_abs + qb
    out = sgn * (l * l + qc)
    return out, s_out  # int value, its scale


def int_gelu(q: torch.Tensor, scale: float):
    """i-GELU: q/2 · (1 + i_erf(q/√2)). Returns (int32 value, out scale)."""
    if scale < MIN_GELU_SCALE:
        raise ValueError(f"int_gelu requires scale ≥ {MIN_GELU_SCALE}")
    q_erf, s_erf = int_erf(q, scale / math.sqrt(2.0))
    one = int(math.floor(1.0 / s_erf))
    out = q.to(torch.int32) * (q_erf + one)
    return out, scale * s_erf / 2.0


def gelu_constants(scale: float, out_scale: float):
    """(qb, qc, one, m, shift): every constant of ``int_gelu_i8`` as ints.

    ``m, shift`` is ``quantize_to_fixed_point(float32(|s| / out_scale))``
    evaluated on the host in float32, exactly as the reference traces it.
    """
    if scale < MIN_GELU_SCALE:
        raise ValueError(f"int_gelu requires scale ≥ {MIN_GELU_SCALE}")
    qb, qc, s_erf = _erf_constants(scale / math.sqrt(2.0))
    one = int(math.floor(1.0 / s_erf))
    s = scale * s_erf / 2.0
    frac, exp = np.frexp(np.float32(abs(s) / out_scale))
    x = np.float32(frac) * np.float32(1 << 15)
    m = int(np.trunc(x + (np.float32(0.5) if x >= 0 else np.float32(-0.5))))
    if m == 1 << 15:
        m >>= 1
        exp += 1
    return qb, qc, one, m, 15 - int(exp)


def int_gelu_i8(q: torch.Tensor, scale: float, out_scale: float) -> torch.Tensor:
    """i-GELU requantized back to int8 with the given output scale."""
    from repro_torch.core.quant import requantize

    _, _, _, m, shift = gelu_constants(scale, out_scale)
    val, _ = int_gelu(q, scale)
    # s is negative (a < 0): negate the integer value, fold sign into scale
    return requantize(-val, m, shift)


def int_relu(q: torch.Tensor) -> torch.Tensor:
    return torch.clamp(q, min=0)
