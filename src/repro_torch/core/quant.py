"""INT8 symmetric quantization with fixed-point requantization.

Port of ``repro.core.quant``: 8-bit weights and activations, 32-bit
accumulation, and a requantization step realized as an integer multiply
plus arithmetic shift. Every integer operation here is int32 with the
reference's wrapping semantics (XLA's: a left shift by 32 or more gives 0,
an arithmetic right shift by 32 or more gives the sign), so the plain
versions, the JAX oracles and the CUDA epilogue agree bit for bit.

Division by a constant: XLA rewrites ``x / c`` inside ``jit`` into
``x * (1/c)`` (the f32 reciprocal), and runs a true division eagerly. The
port mirrors whichever the reference call site does: ``recip32`` gives the
reciprocal for the traced call sites (activation and KV quantization, the
int8 attention's q requantization); weight quantization runs eagerly in the
reference and divides.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

INT8_MIN = -127  # symmetric: -128 is never produced
INT8_MAX = 127
MULT_BITS = 15  # fixed-point multiplier width (16×16 signed multiplier)
_PRE_SHIFT = 15
_SMALL_ACC = 1 << 16


def recip32(c: float) -> float:
    """The f32 reciprocal XLA substitutes for a division by constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 on ``like``'s device. A Python number is filled in
    place there: ``as_tensor`` would copy it from the host, and on a card
    each such copy waits for every queued launch."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.int32, device=like.device)
    return torch.as_tensor(x, dtype=torch.int32, device=like.device)


def _shl(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int32 ``v << s`` for ``s >= 0``; a shift of 32 or more gives 0."""
    return torch.where(s >= 32, torch.zeros_like(v), v << s.clamp(0, 31))


def _sra(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int32 arithmetic ``v >> s`` for ``s >= 0`` (32 or more: the sign)."""
    return v >> s.clamp(0, 31)


def compute_scale(x: torch.Tensor, axis=None, eps: float = 1e-8) -> torch.Tensor:
    """amax-based symmetric scale. ``axis=None`` → per-tensor scalar scale."""
    a = x.abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=eps) / INT8_MAX


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero — matches the TAC requant rounding mode."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric quantize to int8 (round-half-away-from-zero like the RTL)."""
    q = _round_half_away(x / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def round_shift(v: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift by ``s`` with round-half-away (int32).

    Negative ``s`` left-shifts. ``s`` may be a per-channel tensor.
    """
    v = v.to(torch.int32)
    s = _i32(s, v)
    pos = s.clamp(min=1)
    sign = torch.where(v >= 0, _i32(1, v), _i32(-1, v))
    rounded = _sra(v + sign * _shl(torch.ones_like(pos), pos - 1), pos)
    shifted_left = _shl(v, (-s).clamp(min=0))
    return torch.where(s > 0, rounded, torch.where(s == 0, v, shifted_left))


def quantize_to_fixed_point(multiplier, bits: int = MULT_BITS
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompose a real multiplier M as ``m * 2**(-shift)``.

    Returns (m:int32 ∈ [2**(bits-1), 2**bits), shift:int32); shapes follow
    ``multiplier``.
    """
    multiplier = torch.as_tensor(multiplier, dtype=torch.float32)
    frac, exp = torch.frexp(multiplier)  # multiplier = frac * 2**exp
    m = _round_half_away(frac * float(1 << bits)).to(torch.int32)
    overflow = m == (1 << bits)
    m = torch.where(overflow, m >> 1, m)
    exp = torch.where(overflow, exp + 1, exp)
    shift = bits - exp
    return m, shift.to(torch.int32)


def quantize_to_fixed_point_py(multiplier: float, bits: int = MULT_BITS):
    """Python-level twin of ``quantize_to_fixed_point`` for static scales."""
    frac, exp = math.frexp(float(multiplier))
    m = int(round(frac * (1 << bits)))
    if m == (1 << bits):
        m >>= 1
        exp += 1
    return m, bits - exp


def requantize(acc: torch.Tensor, m, shift) -> torch.Tensor:
    """Fixed-point requantization of an int32 accumulator to int8.

    ``y ≈ clip(round(acc * m / 2**shift))`` using only int32 arithmetic:

      * |acc| < 2¹⁶ : exact product (fits: 2¹⁶·2¹⁵ = 2³¹).
      * otherwise   : pre-normalize ``acc`` right by the excess of its
        magnitude exponent over 15 (rounded), multiply, shift by the rest;
        a shift smaller than the pre-shift saturates.
    """
    acc = acc.to(torch.int32)
    m = _i32(m, acc)
    shift = _i32(shift, acc)
    y_small = round_shift(acc * m, shift)
    # magnitude exponent from the float32 bit pattern: |acc| ∈ [2^(e−1), 2^e)
    bits = acc.abs().to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126
    pre = (e - _PRE_SHIFT).clamp(min=0)
    acc_n = round_shift(acc, pre)
    sat = torch.where(acc >= 0, _i32(INT8_MAX, acc), _i32(INT8_MIN, acc))
    y_big = torch.where(shift - pre < 0, sat,
                        round_shift(acc_n * m, (shift - pre).clamp(min=0)))
    y = torch.where(acc.abs() < _SMALL_ACC, y_small, y_big)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def quantize_weights(w: torch.Tensor, per_channel: bool = True):
    """Quantize a [in, out] weight matrix. Returns (w_q:int8, scale:[out])."""
    axis = 0 if per_channel else None
    scale = compute_scale(w, axis=axis)
    wq = quantize(w, scale)
    return wq, (scale.squeeze(0) if per_channel else scale)
