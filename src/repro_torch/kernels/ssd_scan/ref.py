"""Plain PyTorch versions of the Mamba-2 SSD scan.

Port of ``repro.kernels.ssd_scan.ref`` (the sequential oracle and the
one-token decode update) and of ``repro.kernels.ssd_scan.ops._ssd_chunked_xla``
(the chunked matmul form, einsum for einsum) — the version the Hopper kernel
(``csrc/ssd_scan.cu``) is held to on the card.

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
    """The chunked matmul form over whole chunks (``S % chunk == 0``).

    Mirrors ``_ssd_chunked_xla``: per chunk, s = cumsum(dta); the intra-chunk
    output ``(C·Bᵀ ∘ exp(s_t − s_τ)[τ ≤ t]) · x``; the inter-chunk output
    ``exp(s_t)·C·state``; the carried state
    ``exp(s_L)·state + (B ∘ exp(s_L − s_τ))ᵀ · x``. Returns y [B, H, S, P]
    in ``x``'s dtype, and the final state [B, H, N, P] float32 when
    ``return_state``.
    """
    bsz, h, s, p = x.shape
    g, n = b_mat.shape[1], b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    dta_c = dta.reshape(bsz, h, nc, chunk).float()
    x_c = x.reshape(bsz, h, nc, chunk, p).float()
    b_c = _heads(b_mat.reshape(bsz, g, nc, chunk, n).float(), h)
    c_c = _heads(c_mat.reshape(bsz, g, nc, chunk, n).float(), h)
    s_a = torch.cumsum(dta_c, dim=-1)                      # [B, H, NC, L]
    idx = torch.arange(chunk, device=x.device)
    causal = idx[None, :] <= idx[:, None]                  # [L, L], τ ≤ t
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        dta_i = s_a[:, :, ci]                              # [B, H, L]
        x_i, b_i, c_i = x_c[:, :, ci], b_c[:, :, ci], c_c[:, :, ci]
        delta = dta_i[..., :, None] - dta_i[..., None, :]
        # exp only where τ ≤ t: above the diagonal delta > 0 may overflow
        ldec = torch.where(causal, torch.exp(torch.where(causal, delta, 0.0)),
                           0.0)
        scores = torch.einsum("bhln,bhmn->bhlm", c_i, b_i) * ldec
        y_intra = torch.einsum("bhlm,bhmp->bhlp", scores, x_i)
        y_inter = torch.exp(dta_i)[..., None] * torch.einsum(
            "bhln,bhnp->bhlp", c_i, state)
        s_last = dta_i[..., -1]
        w = torch.exp(s_last[..., None] - dta_i)           # [B, H, L]
        state = torch.exp(s_last)[..., None, None] * state + torch.einsum(
            "bhln,bhlp->bhnp", b_i * w[..., None], x_i)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=2).reshape(bsz, h, s, p).to(x.dtype)
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
