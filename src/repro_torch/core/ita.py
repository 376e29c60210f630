"""Integer-only softmax and GELU — the arithmetic of CHIMERA's TAC engines.

Port of ``repro.core.ita``: the softmax engine (ITA's base-2 integer
softmax over int8 logits, two-pass and streaming) and the per-PE
activation unit (I-BERT-style integer erf/GELU). Everything is int32 with
the reference's semantics (XLA's: an arithmetic right shift by a count
outside [0, 31] gives the sign).

Base-2 softmax: ``softmax(x)_i = 2^((x_i − max)·α) / Σ_j 2^((x_j − max)·α)``
with ``α = s_logit · log2(e)`` encoded as ``(mult, rshift)``. For an int8
logit q::

    t  = (q − max) · mult  >>  rshift      # Q(FB) fixed point, t ≤ 0
    ip = t >> FB                           # integer part
    fp = t − ip·2^FB                       # fractional part ∈ [0, 2^FB)
    2^(t/2^FB) ≈ (2^FB + fp) >> (−ip)      # linear mantissa: 2^f ≈ 1+f

The streaming form keeps the running maximum as an integer block exponent,
so every rescale of a partial sum is an exact arithmetic shift (what the
fused attention kernel, ``kernels/ita_attention``, runs per kv tile).

``gelu_constants`` folds every float-derived constant of the activation
unit into Python ints once, which is how the int8 GEMM's CUDA epilogue
receives them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device

# Fixed-point fraction bits of the exponent domain.
FB = 8
ONE = 1 << FB
LOG2E = math.log2(math.e)
PROB_BITS = 8  # probabilities re-emitted as uint8 (0..255)
PROB_MAX = (1 << PROB_BITS) - 1
NEG_T = -(31 << FB)  # exponent-domain −∞: exp2_fixed gives exactly 0


@functools.lru_cache(maxsize=None)
def _alpha_fixed(logit_scale: float):
    """Encode α = s·log2e as (mult, rshift) with mult ∈ [2⁶, 2¹⁴)."""
    alpha = logit_scale * LOG2E
    if alpha <= 0:
        raise ValueError("logit_scale must be positive")
    k = 0
    while round(alpha * ONE * (1 << k)) < (1 << 6) and k < 24:
        k += 1
    mult = int(round(alpha * ONE * (1 << k)))
    while mult >= (1 << 14):  # keep the int8·mult product within int32
        mult >>= 1
        k -= 1
    return max(mult, 1), k


@dataclasses.dataclass(frozen=True)
class SoftmaxSpec:
    """Static metadata tying the int8 logit scale to fixed-point constants."""

    logit_scale: float  # scale of the int8 logits entering the engine

    @property
    def alpha_mult(self) -> int:
        return _alpha_fixed(self.logit_scale)[0]

    @property
    def alpha_rshift(self) -> int:
        return _alpha_fixed(self.logit_scale)[1]


def sra_count(s: int) -> int:
    """A static right-shift count as int32 hardware takes it: a count
    outside [0, 31] (a negative ``alpha_rshift`` at logit scales ≥ 44)
    shifts out everything but the sign, as XLA's does."""
    return s if 0 <= s <= 31 else 31


def to_exponent_domain(dlogits: torch.Tensor, spec: SoftmaxSpec) -> torch.Tensor:
    """(q − max) int values → Q(FB) base-2 exponents t ≤ 0 (int32-safe)."""
    t = dlogits.to(torch.int32) * spec.alpha_mult
    t = t >> sra_count(spec.alpha_rshift)  # floor keeps t ≤ 0 conservative
    return torch.clamp(t, min=NEG_T)


def exp2_fixed(t: torch.Tensor) -> torch.Tensor:
    """2^(t / 2^FB) in Q(FB), for t ≤ 0 (int32). Returns int32 in [0, 2^FB]."""
    ip = t >> FB  # arithmetic shift → floor
    fp = t - ip * ONE
    mant = ONE + fp  # 2^f ≈ 1 + f, f ∈ [0,1)
    return mant >> torch.clamp(-ip, 0, 31)


def int_softmax(logits_q: torch.Tensor, spec: SoftmaxSpec, axis: int = -1):
    """Two-pass integer softmax over int8 logits (the non-streaming oracle).

    Returns ``(probs_u8, denom)``: uint8 probabilities with implicit scale
    ``1/PROB_MAX`` and the int32 denominator (kept dim). int32 headroom:
    e ≤ 2^FB per element, so rows of up to 2²² elements sum below 2³¹.
    """
    x = logits_q.to(torch.int32)
    m = x.amax(dim=axis, keepdim=True)
    e = exp2_fixed(to_exponent_domain(x - m, spec))
    denom = e.sum(dim=axis, keepdim=True, dtype=torch.int32)
    d = torch.clamp(denom, min=1)
    probs = (e * PROB_MAX + (d >> 1)) // d  # round-half-up division
    return probs.to(torch.uint8), denom


def int_softmax_float_view(logits_q: torch.Tensor, spec: SoftmaxSpec,
                           axis: int = -1) -> torch.Tensor:
    """Integer softmax dequantized to float (for error measurement)."""
    probs, _ = int_softmax(logits_q, spec, axis=axis)
    return probs.to(torch.float32) / PROB_MAX


def streaming_init(num_rows: int, device: DeviceLike = None):
    """Running state ``(block_exp, denom)``, int32 [rows] each.

    ``block_exp`` is the running maximum rounded up to an integer exponent;
    it starts at −31 (not −∞), which a row with no valid key yet keeps.
    """
    dev = resolve_device(device)
    return (torch.full((num_rows,), -31, dtype=torch.int32, device=dev),
            torch.zeros((num_rows,), dtype=torch.int32, device=dev))


def _block_exp(t_max: torch.Tensor) -> torch.Tensor:
    """ceil(t/2^FB): smallest integer exponent ≥ a Q(FB) exponent value."""
    return -((-t_max) >> FB)


def streaming_tile_update(state, tile_t: torch.Tensor):
    """Fold one tile of exponent-domain logits ``t`` into the running state.

    ``tile_t``: int32 [rows, tile] — q·α in Q(FB), not max-subtracted.
    Returns ``(new_state, e_tile, carry_shift)``: the tile's exponentials
    relative to the new block exponent, and the exact right shift the
    caller applies to any companion accumulator (partial AV sums).
    """
    be, denom = state
    be_new = torch.maximum(be, _block_exp(tile_t.amax(dim=-1)))
    sh = torch.clamp(be_new - be, 0, 31)
    e = exp2_fixed(torch.clamp(tile_t - be_new[..., None] * ONE, min=NEG_T))
    denom_new = (denom >> sh) + e.sum(dim=-1, dtype=torch.int32)
    return (be_new, denom_new), e, sh


# ---------------------------------------------------------------------------
# Integer GELU / ReLU — the per-PE activation unit (I-BERT-style i-GELU)
# ---------------------------------------------------------------------------

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
