"""Shared neural-net layers (plain functions on tensors).

Port of ``repro.models.layers``; the float32 up-casts sit exactly where the
JAX code has them, so bf16 compute rounds at the same places.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + gamma.float())).to(dt)


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
