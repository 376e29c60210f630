"""Plain PyTorch versions of the RG-LRU recurrence.

Port of ``repro.kernels.rglru.ref``: the sequential scan (the version the
Hopper kernel, ``csrc/rglru.cu``, is held to on the card) and the
one-token decode update. Both run in float32:

    h_t = a_t·h_{t−1} + β_t·u_t,   a_t = exp(log_a_t),
    β_t = sqrt(−expm1(2·log_a_t))  (= √(1 − a_t²), stable as a_t → 1),

with h₀ = 0. ``log_a`` [B, S, D] is ≤ 0; ``u`` [B, S, D] is the gated input
i ⊙ x. Each product and sum is its own rounding (no fused multiply-add),
which the kernel mirrors.
"""

from __future__ import annotations

import torch


def _decay_and_input(log_a: torch.Tensor, u: torch.Tensor):
    la = log_a.float()
    return torch.exp(la), torch.sqrt(-torch.expm1(2.0 * la)) * u.float()


def rglru_ref(log_a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The recurrence scanned over time: [B, S, D] → [B, S, D] in
    ``u.dtype``."""
    a, bu = _decay_and_input(log_a, u)
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + bu[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(u.dtype)


def rglru_decode_step(h: torch.Tensor, log_a_t: torch.Tensor,
                      u_t: torch.Tensor):
    """One-token update. h [B, D] float32; log_a_t/u_t [B, D]. Returns
    ``(h_new float32, h_new in u_t.dtype)``."""
    a, bu = _decay_and_input(log_a_t, u_t)
    h = a * h + bu
    return h, h.to(u_t.dtype)
