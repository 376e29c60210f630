"""Plain PyTorch versions of the Mamba-2 SSD scan.

Port of ``repro.kernels.ssd_scan.ref`` (the sequential oracle and the
one-token decode update) and of ``repro.kernels.ssd_scan.ops._ssd_chunked_xla``
(the chunked matmul form, einsum for einsum) — the version the Hopper kernel
(``csrc/ssd_scan.cu``) is held to on the card, written in the order the
kernel computes it.

Layouts are head-major, as in the reference: ``dta`` [B, H, S] (Δ·A, the
per-step decay log, A < 0 folded in), ``x`` [B, H, S, P] (Δ folded in),
``b_mat``/``c_mat`` [B, G, S, N]; head ``h`` reads group ``h // (H // G)``.
The carried state is [B, H, N, P] float32.
"""

from __future__ import annotations

import torch


def _heads(mat: torch.Tensor, h: int) -> torch.Tensor:
    """[B, G, ...] → [B, H, ...]: head ``h`` reads group ``h // (H/G)``."""
    return mat.repeat_interleave(h // mat.shape[1], dim=1)


def ssd_scan_ref(dta, x, b_mat, c_mat):
    """Step-by-step SSD recurrence in float32 (the sequential oracle).

    ``state_t = exp(dta_t)·state_{t-1} + B_t x_tᵀ``; ``y_t = C_t·state_t``.
    Returns y [B, H, S, P] in ``x``'s dtype.
    """
    bsz, h, s, p = x.shape
    n = b_mat.shape[-1]
    bh_b = _heads(b_mat, h).float()
    bh_c = _heads(c_mat, h).float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state, y = ssd_decode_step(state, dta[:, :, t], x[:, :, t].float(),
                                   bh_b[:, :, t], bh_c[:, :, t])
        ys.append(y)
    if not ys:
        return x.new_zeros(x.shape)
    return torch.stack(ys, dim=2).to(x.dtype)


def ssd_decode_step(state, dta_t, x_t, b_t, c_t):
    """Single-token update: state [B, H, N, P]; dta_t [B, H]; x_t [B, H, P];
    b_t/c_t [B, H, N]. Returns (new_state, y [B, H, P] in ``x_t``'s dtype)."""
    a = torch.exp(dta_t.float())[..., None, None]
    state = a * state + torch.einsum("bhn,bhp->bhnp", b_t.float(),
                                     x_t.float())
    y = torch.einsum("bhn,bhnp->bhp", c_t.float(), state)
    return state, y.to(x_t.dtype)


def ssd_scan_chunked_ref(dta, x, b_mat, c_mat, chunk: int,
                         return_state: bool = False):
    """The chunked matmul form, in the order the Hopper kernel computes it.

    The algebra of ``_ssd_chunked_xla``, with s = cumsum(dta) in a chunk:
    1. C·Bᵀ once per (batch, group, chunk), over its lower triangle τ ≤ t;
    2. every chunk's local state ``Sc = Σ_τ exp(s_L − s_τ)·B_τ x_τᵀ`` and
       decay ``exp(s_L)``, all chunks at once;
    3. the chain over chunks in order: the state entering chunk 0 is 0,
       entering chunk c + 1 it is ``exp(s_L,c)·state_c + Sc_c`` (the last
       one is the final state);
    4. ``y = (C·Bᵀ ∘ exp(s_t − s_τ))[τ ≤ t] · x + exp(s_t)·C·state_c``.

    A ragged last chunk acts as the reference's zero padding. Returns y
    [B, H, S, P] in ``x``'s dtype, and the final state [B, H, N, P] float32
    when ``return_state``.
    """
    bsz, h, s, p = x.shape
    g, n = b_mat.shape[1], b_mat.shape[-1]
    dta_p, x_p, b_p, c_p = pad_to_chunks(dta.float(), x.float(),
                                         b_mat.float(), c_mat.float(), chunk)
    nc = x_p.shape[2] // chunk
    s_a = torch.cumsum(dta_p.reshape(bsz, h, nc, chunk), dim=-1)
    x_c = x_p.reshape(bsz, h, nc, chunk, p)
    b_c = b_p.reshape(bsz, g, nc, chunk, n)
    c_c = c_p.reshape(bsz, g, nc, chunk, n)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[None, :] <= idx[:, None]                  # [L, L], τ ≤ t
    cb = torch.where(causal, torch.einsum("bgcln,bgcmn->bgclm", c_c, b_c),
                     0.0)                                  # [B, G, NC, L, L]
    s_last = s_a[..., -1]                                  # [B, H, NC]
    w = torch.exp(s_last[..., None] - s_a)
    local = torch.einsum("bhcln,bhclp->bhcnp", _heads(b_c, h) * w[..., None],
                         x_c)                              # [B, H, NC, N, P]
    decay = torch.exp(s_last)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = decay[:, :, ci, None, None] * state + local[:, :, ci]
    delta = s_a[..., :, None] - s_a[..., None, :]
    # exp only where τ ≤ t: above the diagonal delta > 0 may overflow
    ldec = torch.where(causal, torch.exp(torch.where(causal, delta, 0.0)),
                       0.0)
    y = torch.einsum("bhclm,bhcmp->bhclp", _heads(cb, h) * ldec, x_c)
    y = y + torch.exp(s_a)[..., None] * torch.einsum(
        "bhcln,bhcnp->bhclp", _heads(c_c, h), torch.stack(entering, dim=2))
    y = y.reshape(bsz, h, nc * chunk, p)[:, :, :s].to(x.dtype)
    return (y, state) if return_state else y


def pad_to_chunks(dta, x, b_mat, c_mat, chunk: int):
    """Zero-pad the sequence axis to a multiple of ``chunk``: Δ·A = 0 keeps
    the decay at 1 and B = 0 leaves the state untouched, so the padded
    positions change nothing but their own (discarded) outputs."""
    pad = (-x.shape[2]) % chunk
    if not pad:
        return dta, x, b_mat, c_mat

    def pz(a):
        shape = list(a.shape)
        shape[2] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=2)

    return pz(dta), pz(x), pz(b_mat), pz(c_mat)
