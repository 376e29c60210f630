"""Plain PyTorch versions of the standalone integer softmax.

Port of ``repro.kernels.int_softmax.ref``: ``int_softmax_ref`` is the
two-pass ITA integer softmax (``core.ita.int_softmax``), the version the
Hopper kernel (``csrc/int_softmax.cu``) is held to bit for bit on the card;
``int_softmax_table_ref`` is the same function in the kernel's order (an
exponent table over k = max − x, then a division by a per-row reciprocal),
which nothing on the main path calls: it documents the kernel and proves
the identity on the CPU; ``softmax_float_ref`` is the float softmax it
approximates.
"""

from __future__ import annotations

import torch

from repro_torch.core import ita


def int_softmax_ref(logits_q: torch.Tensor, *, logit_scale: float
                    ) -> torch.Tensor:
    """int8 logits [..., C] → uint8 probabilities [..., C] (scale 1/255)."""
    probs, _ = ita.int_softmax(logits_q, ita.SoftmaxSpec(logit_scale), axis=-1)
    return probs


def exponent_table(spec: ita.SoftmaxSpec) -> torch.Tensor:
    """E[k] = exp2_fixed(max((−k · mult) >> rshift, NEG_T)) for k = 0..255:
    the exponential of every logit k below its row's maximum (int32 [256])."""
    k = torch.arange(256, dtype=torch.int32)
    return ita.exp2_fixed(ita.to_exponent_domain(-k, spec))


def reciprocal(den: torch.Tensor):
    """(c, F) with n // den = (n · c) >> F for every n = e · 255 + den // 2
    a row forms (e ≤ 256), c = ceil(2^F / den) < 2^32 (int64 tensors, for
    256 ≤ den ≤ 2^30). With 2^(L−1) < den ≤ 2^L and n < 2^max(18, L), any
    F in [max(32, max(18, L) + L), 31 + L] is exact (Granlund and
    Montgomery); F = 31 + L for every n < 2^31. The kernel takes the
    smallest F with F − 32 a multiple of 8 where there is one, so that the
    quotient is a byte of its 32-bit multiply-high."""
    d = den.to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64)
    big_l = (((d - 1).unsqueeze(-1) >> bits) > 0).sum(-1)   # ceil(log2 d)
    lo = torch.clamp(torch.clamp(big_l, min=18) + big_l, min=32)
    f = 32 + (lo - 32 + 7) // 8 * 8
    f = torch.where(f > 31 + big_l, 31 + big_l, f)
    c = ((torch.ones_like(d) << f) + d - 1) // d
    return c, f


def divide(n: torch.Tensor, c: torch.Tensor, f: torch.Tensor
           ) -> torch.Tensor:
    """n // den from ``reciprocal(den)``, for 0 ≤ n < 2^31 (the kernel's
    umulhi(c, n) >> (F − 32))."""
    return (c * n.to(torch.int64)) >> f


def int_softmax_table_ref(logits_q: torch.Tensor, *, logit_scale: float
                          ) -> torch.Tensor:
    """``int_softmax_ref`` in the Hopper kernel's order: e = E[max − x] from
    ``exponent_table``, p = (e · 255 + den // 2) // den by ``divide``
    (den ≥ 256: the maximum's own e is E[0] = 256, so max(den, 1) never
    binds)."""
    spec = ita.SoftmaxSpec(logit_scale)
    x = logits_q.to(torch.int32)
    k = (x.amax(dim=-1, keepdim=True) - x).long()
    e = exponent_table(spec)[k]
    den = e.sum(dim=-1, keepdim=True, dtype=torch.int32)
    c, f = reciprocal(den)
    probs = divide(e * ita.PROB_MAX + (den >> 1), c, f)
    return probs.to(torch.uint8)


def softmax_float_ref(logits_q: torch.Tensor, *, logit_scale: float
                      ) -> torch.Tensor:
    return torch.softmax(logits_q.to(torch.float32) * logit_scale, dim=-1)
