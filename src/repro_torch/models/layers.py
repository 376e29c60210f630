"""Shared neural-net layers (plain functions on tensors).

Port of ``repro.models.layers``; the float32 up-casts sit exactly where the
JAX code has them, so bf16 compute rounds at the same places.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32 (biased variance, as ``jnp.var``); the output is
    cast back to the input dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [..., S, D] (D even); positions: [..., S]."""
    d = x.shape[-1]
    dt = x.dtype
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    # rotate-half convention (matches HF Llama/Gemma/Phi)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up


ACTIVATIONS = {"swiglu": swiglu, "geglu": geglu}


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, N] in the compute dtype of x."""
    return x @ w.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return table.to(compute_dtype)[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32 (stable softmax/loss)."""
    return x.float() @ table.float().T


def unstack(group: dict) -> dict:
    """A stacked layer group's leaves taken apart along the stack axis
    once (``unbind``: views), so that selecting layer ``g`` of each is a
    tuple index. Under autograd, indexing a stacked tensor per layer
    would make each layer's backward write a zero-filled gradient of the
    whole stack; ``unbind``'s backward stacks the layers' gradients once.
    Leaves already taken apart (tuples or lists) pass through."""
    return {k: v.unbind(0) if isinstance(v, torch.Tensor) else v
            for k, v in group.items()}


def remat(fn, enabled: bool):
    """``fn`` recomputed in the backward pass instead of saving its
    internals (``torch.utils.checkpoint``, non-reentrant), as the
    reference wraps a layer group's body in ``jax.checkpoint``; ``fn``
    itself when ``enabled`` is off or grad mode is off (serving)."""
    if not (enabled and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)
