"""Optimizers: AdamW and Adafactor (port of ``repro.optim.optimizer``).

The states are NamedTuples of tensor trees shaped like the parameters
(``AdamWState(step, m, v)``, ``AdafactorState(step, vr, vc)``, ``step`` an
int32 scalar tensor), so a checkpoint's keys are the reference's.

``update`` works **in place**, one leaf at a time and, for a stacked leaf
(three or more dims: a leading layer axis), one stack entry at a time,
under ``torch.no_grad()``: the reference's ``jax.tree.map`` builds whole
new trees, and at full width a whole-leaf temporary of a 3 GB stack would
cost gigabytes of peak memory. The arithmetic is the reference's, in
float32, operation for operation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.schema import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"       # cosine | linear | const


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), as a
    float32 scalar tensor computed in float32 as the reference does."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def _by_entry(p: torch.Tensor, *others: torch.Tensor):
    """Tuples of matching views of ``p`` and the tensors that go with it
    (its gradient and state leaves), one per stack entry of ``p``."""
    if p.dim() < 3:
        return [(p, *others)]
    return list(zip(p.unbind(0), *(o.unbind(0) for o in others)))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        for (e,) in _by_entry(x):
            total = total + torch.sum(torch.square(e.float()))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scales the float32 leaves of ``tree`` in place so their global norm
    is at most ``max_norm``; returns ``(tree, norm before clipping)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale)
    return tree, norm


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any  # row second moments (or full moments for rank<2)
    vc: Any  # col second moments


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def init(cfg: OptConfig, params):
    """Zero state on the parameters' device."""
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    if cfg.name == "adamw":
        return AdamWState(_step0(params),
                          tree_map(lambda p: zeros(p.shape, p), params),
                          tree_map(lambda p: zeros(p.shape, p), params))
    if cfg.name == "adafactor":
        def vr_like(p):
            return zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, p)

        def vc_like(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (),
                         p)

        return AdafactorState(_step0(params), tree_map(vr_like, params),
                              tree_map(vc_like, params))
    raise ValueError(cfg.name)


def _map_axes(fn, tree):
    """Map over a tree of dicts and lists whose leaves are axes tuples."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    return fn(tree)


def state_axes(cfg: OptConfig, params_axes):
    """Logical axes for the optimizer state, mirroring the param axes (a
    tree of dicts and lists with axes tuples for leaves)."""
    if cfg.name == "adamw":
        return AdamWState((), params_axes, params_axes)

    def drop_last(a):
        return a[:-1] if len(a) >= 2 else a

    def drop_second_last(a):
        return a[:-2] + a[-1:] if len(a) >= 2 else ()

    return AdafactorState((), _map_axes(drop_last, params_axes),
                          _map_axes(drop_second_last, params_axes))


def _adamw_leaf(cfg: OptConfig, p, g, m, v, lr, bc1, bc2) -> None:
    for pe, ge, me, ve in _by_entry(p, g, m, v):
        me.mul_(cfg.b1).add_(ge * (1 - cfg.b1))
        ve.mul_(cfg.b2).add_((ge * (1 - cfg.b2)).mul_(ge))
        denom = (ve / bc2).sqrt_().add_(cfg.eps)
        delta = (me / bc1).div_(denom).add_(pe.float() * cfg.weight_decay)
        pe.copy_(pe.float() - delta.mul_(lr))


def _adafactor_leaf(cfg: OptConfig, p, g, vr, vc, lr) -> None:
    d = 1e-30
    if g.dim() < 2:
        vr.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        denom = (vr + d).sqrt_()
        p.copy_(p.float() - lr * (g / (denom + cfg.eps)
                                  + cfg.weight_decay * p.float()))
        return
    for pe, ge, re, ce in _by_entry(p, g, vr, vc):
        gg = ge * ge
        re.mul_(cfg.b2).add_(gg.mean(-1) * (1 - cfg.b2))
        ce.mul_(cfg.b2).add_(gg.mean(-2) * (1 - cfg.b2))
        del gg
        denom = (re[..., None] * ce[..., None, :]
                 / (re.mean(-1, keepdim=True)[..., None] + d)).add_(d).sqrt_()
        delta = (ge / denom.add_(cfg.eps)).add_(pe.float()
                                                * cfg.weight_decay)
        pe.copy_(pe.float() - delta.mul_(lr))


@torch.no_grad()
def update(cfg: OptConfig, state, params, grads):
    """One optimizer step, in place: returns ``(params, new_state,
    {"lr", "grad_norm"})``, where ``params`` and the state's moment trees
    are the trees passed in, updated. ``grads`` (a tree shaped like
    ``params``) is consumed: float32 leaves are clipped in place."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_at(cfg, step)
    flat_p, flat_g = leaves(params), leaves(grads)

    if cfg.name == "adamw":
        bc1, bc2 = (1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                             device=step.device),
                                  step.float())
                    for b in (cfg.b1, cfg.b2))
        for p, g, m, v in zip(flat_p, flat_g, leaves(state.m),
                              leaves(state.v)):
            _adamw_leaf(cfg, p, g, m, v, lr, bc1, bc2)
        new_state = AdamWState(step, state.m, state.v)
    elif cfg.name == "adafactor":
        for p, g, vr, vc in zip(flat_p, flat_g, leaves(state.vr),
                                leaves(state.vc)):
            _adafactor_leaf(cfg, p, g, vr, vc, lr)
        new_state = AdafactorState(step, state.vr, state.vc)
    else:
        raise ValueError(cfg.name)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
