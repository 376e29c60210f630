"""Training loop on one device: the loss, the train step with gradient
accumulation, and a trainer with checkpoints (port of
``repro.train.trainer``).

Fault-tolerance contract, the reference's on one device:

  * **checkpoint/restart** — atomic-commit checkpoints every
    ``ckpt_every`` steps (async writer); ``Trainer.restore_if_any``
    resumes from the newest commit. Data is step-indexed, so the resumed
    batch stream is bit-identical. The checkpoint layout and keys are the
    reference's, so either package restores the other's.
  * **preemption** — SIGTERM triggers a final synchronous checkpoint.
  * **straggler detection** — per-step wall-time EWMA; steps slower than
    ``straggler_factor``× the EWMA are logged with the device.

Gradients. ``loss_and_grads`` differentiates the family's ``forward``
(every family's is differentiable on the CPU; the ssm and hybrid families'
scan kernels on the card have no backward yet and refuse by name). Each
stacked parameter leaf is handed to the forward as per-layer leaves: views
of the leaf, detached, each with its ``.grad`` preset to the matching
entry of one float32 accumulator shaped like the parameters. Autograd
adds each layer's gradient into that entry in place, so neither a
whole-stack zero-filled gradient per layer nor a stack of the layers'
gradients is ever built; with ``microbatches`` = G the G backward passes
accumulate into the same buffer, each seeded with 1/G (the reference adds
``g / G`` for each slice; for G a power of two the two agree bit for bit).

Not ported yet (the mesh slice): FSDP (``fsdp`` is accepted and means
nothing on one device), ``dp_compress`` (refused) and
``make_compressed_train_step``.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.data.pipeline import DataConfig, device_batch
from repro_torch.models import registry
from repro_torch.models import schema as schema_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import tree_map
from repro_torch.optim import optimizer as opt_lib


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig
    opt: opt_lib.OptConfig
    global_batch: int = 32
    seq_len: int = 256
    microbatches: int = 1
    fsdp: bool = True
    cast_params_bf16: bool = False  # bf16 weights in the forward
    dp_compress: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_async: bool = True
    straggler_factor: float = 3.0
    seed: int = 0


def _refuse_dp_compress(tc: TrainConfig) -> None:
    if tc.dp_compress:
        raise NotImplementedError(
            "not ported to repro_torch yet: dp_compress (mesh)")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll.mean()


def make_loss_fn(arch: registry.Arch, cast_bf16: bool = False) -> Callable:
    """``loss_fn(params, tokens, embeds=None)``: next-token cross entropy
    of ``tokens`` [B, S]. ``embeds`` align with the input tokens
    (``embeds[:, :-1]``) except for encdec, whose frame embeddings go in
    whole. ``cast_bf16`` casts the float32 leaves to bfloat16 first."""
    def loss_fn(params, tokens, embeds=None):
        if cast_bf16:
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        kw = {}
        if embeds is not None:
            kw["embeds"] = (embeds[:, :-1]
                            if arch.cfg.family != "encdec" else embeds)
        logits = arch.forward(params, inp, **kw)
        return cross_entropy(logits, tgt)

    return loss_fn


def _zip_map(fn, *trees):
    """Map ``fn`` over the matching leaves of trees of dicts and lists."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_zip_map(fn, *z) for z in zip(*trees)]
    return fn(*trees)


def _grad_leaf(p: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    leaf = p.detach().requires_grad_()
    leaf.grad = grad
    return leaf


def _grad_leaves(p: torch.Tensor, spec, acc: torch.Tensor):
    """``p`` as autograd leaves whose gradients land in ``acc``: one leaf
    per layer for a stacked leaf (the schema's ``layers`` axis first),
    else one."""
    if spec.axes[:1] == ("layers",):
        return tuple(_grad_leaf(pi, ai)
                     for pi, ai in zip(p.unbind(0), acc.unbind(0)))
    return _grad_leaf(p, acc)


def loss_and_grads(loss_fn: Callable, params, schema, tokens: torch.Tensor,
                   embeds: Optional[torch.Tensor] = None,
                   microbatches: int = 1):
    """``(loss, grads)``: the mean of ``loss_fn`` over ``microbatches``
    equal slices of the batch, and its float32 gradient, a tree shaped
    like ``params`` (float32 leaves). ``schema`` is the parameters'
    (``arch.schema()``)."""
    g = microbatches
    b = tokens.shape[0]
    if b % g:
        raise ValueError(f"batch {b} does not split into {g} microbatches")
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    leaves = _zip_map(_grad_leaves, params, schema, acc)
    toks = tokens.reshape(g, b // g, *tokens.shape[1:])
    embs = (None if embeds is None
            else embeds.reshape(g, b // g, *embeds.shape[1:]))
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(g):
        li = loss_fn(leaves, toks[i], None if embs is None else embs[i])
        li.backward(torch.full_like(li, 1.0 / g))
        loss = loss + li.detach() / g
    return loss, acc


def make_train_step(arch: registry.Arch, tc: TrainConfig):
    """``train_step(params, opt_state, tokens, embeds=None)`` →
    ``(params, opt_state, metrics)``, updating ``params`` and the state in
    place; ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` (scalar
    tensors on the device)."""
    _refuse_dp_compress(tc)
    loss_fn = make_loss_fn(arch, cast_bf16=tc.cast_params_bf16)
    schema = arch.schema()

    def train_step(params, opt_state, tokens, embeds=None):
        loss, grads = loss_and_grads(loss_fn, params, schema, tokens, embeds,
                                     tc.microbatches)
        params, opt_state, metrics = opt_lib.update(tc.opt, opt_state,
                                                    params, grads)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


class Trainer:
    """Trains ``tc.model`` on one device (default ``cuda``). Parameters are
    drawn by ``schema.init_params`` from a generator seeded with
    ``tc.seed``, unless a tensor tree is passed as ``params``."""

    def __init__(self, tc: TrainConfig, device: DeviceLike = None,
                 params=None):
        _refuse_dp_compress(tc)
        self.tc = tc
        self.device = resolve_device(device)
        self.arch = registry.build(tc.model)
        self.schema = self.arch.schema()
        self.data_cfg = DataConfig(
            vocab=tc.model.vocab, seq_len=tc.seq_len,
            global_batch=tc.global_batch, seed=tc.seed)
        self._preempted = False
        self.step = 0
        self._step_ewma = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tc.seed)
            params = schema_lib.init_params(self.schema, gen, self.device)
        self.params = params
        self.opt_state = opt_lib.init(tc.opt, params)
        self._step_fn = make_train_step(self.arch, tc)

    # -- fault tolerance ----------------------------------------------------

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def save(self, sync: bool = False):
        from repro_torch.train import checkpointing as ckpt

        if not self.tc.ckpt_dir:
            return
        tree = {"params": self.params, "opt": self.opt_state}
        ckpt.save(self.tc.ckpt_dir, self.step, tree,
                  meta={"arch": self.tc.model.name},
                  async_write=self.tc.ckpt_async and not sync)

    def restore_if_any(self) -> bool:
        from repro_torch.train import checkpointing as ckpt

        if not self.tc.ckpt_dir:
            return False
        step = ckpt.latest_step(self.tc.ckpt_dir)
        if step is None:
            return False
        like = {"params": self.params, "opt": self.opt_state}
        tree = ckpt.restore(self.tc.ckpt_dir, step, like, self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        return True

    # -- main loop -----------------------------------------------------------

    def run(self, num_steps: int, log_every: int = 10,
            corpus=None) -> list:
        """Steps until ``num_steps`` (or a preemption); returns the logged
        steps' ``{"step", "loss", "grad_norm", "sec"}``, ``sec`` being the
        step's wall time up to its loss on the host."""
        history = []
        while self.step < num_steps and not self._preempted:
            t0 = time.perf_counter()
            tokens = device_batch(self.data_cfg, self.step, self.device,
                                  corpus)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, tokens)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._track_stragglers(dt)
            self.step += 1
            if self.step % log_every == 0 or self.step == num_steps:
                history.append({"step": self.step, "loss": loss,
                                "grad_norm": float(metrics["grad_norm"]),
                                "sec": dt})
            if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
                self.save()
        if self._preempted:
            self.save(sync=True)  # preemption: final synchronous commit
        return history

    def _track_stragglers(self, dt: float):
        if self._step_ewma is None:
            self._step_ewma = dt
            return
        if dt > self.tc.straggler_factor * self._step_ewma:
            print(f"[straggler] step {self.step}: {dt:.3f}s vs "
                  f"EWMA {self._step_ewma:.3f}s — flagging device "
                  f"{self.device}")
        self._step_ewma = 0.9 * self._step_ewma + 0.1 * dt
