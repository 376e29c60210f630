"""PyTorch port vs JAX reference: the training loss and its gradients.

For every assigned architecture at smoke width (float32), one numpy
parameter tree and one batch go through ``jax.value_and_grad`` of the
reference's ``make_loss_fn`` and through the port's ``loss_and_grads``:
the loss at ``rtol = 1e-5`` and **every gradient leaf**, matched by its
tree path, at ``rtol = 1e-4`` with ``atol = 1e-5 · max|g_jax|`` of the
leaf. The encdec family takes frame embeddings whole, vlm-dense takes
embeddings aligned with the input tokens.

Within the port: remat on (``torch.utils.checkpoint`` around each layer
group) gives the gradients of remat off bit for bit, for every family;
moe's gather-only permutations have the backward of plain indexing; a
forward over stacked leaves that require grad (taken apart once by
``unbind``) gives the gradients ``loss_and_grads`` gives; ``fake_quant``
passes the gradient straight through, as the reference's does.
Microbatching, bf16 and ``cast_params_bf16`` are in
``test_torch_train_accum.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.train import trainer as jtrainer
from repro.train.checkpointing import (
    _flatten_with_paths as jflatten_with_paths,
)
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.train import trainer as ttrainer
from repro_torch.train.checkpointing import flatten_with_paths

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def setup_train_pair(name, dtype="float32", batch=2, seq=17, seed=0,
                     **overrides):
    """(JAX arch, port arch, numpy params, numpy tokens, numpy embeds or
    None) for ``name``'s smoke config with ``overrides`` on both sides."""
    jc = dataclasses.replace(jconfigs.smoke_config(name), dtype=dtype,
                             **overrides)
    tc = dataclasses.replace(tconfigs.smoke_config(name), dtype=dtype,
                             **overrides)
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=seed)
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, tc.vocab, (batch, seq)).astype(np.int32)
    emb = None
    if tc.family == "encdec":
        emb = rng.standard_normal((batch, tc.enc_seq, tc.d_model))
    elif tc.family == "vlm-dense":
        emb = rng.standard_normal((batch, seq, tc.d_model))
    emb = None if emb is None else emb.astype(np.float32)
    return jregistry.build(jc), tarch, npp, toks, emb


def reference_value_and_grad(jarch, npp, toks, emb, **kw):
    fn = jax.value_and_grad(jtrainer.make_loss_fn(jarch, **kw))
    return fn(jax.tree.map(jnp.asarray, npp), jnp.asarray(toks),
              None if emb is None else jnp.asarray(emb))


def port_loss_and_grads(tarch, npp, toks, emb, microbatches=1, **kw):
    return ttrainer.loss_and_grads(
        ttrainer.make_loss_fn(tarch, **kw),
        bridge.params_from_numpy(npp, "cpu"), tarch.schema(),
        torch.from_numpy(toks).long(),
        None if emb is None else torch.from_numpy(emb),
        microbatches=microbatches)


def assert_grads_close(got, want):
    g, w = flatten_with_paths(got), jflatten_with_paths(want)
    assert g.keys() == w.keys()
    for k, ref in w.items():
        ref = np.asarray(ref)
        assert g[k].dtype == torch.float32, k
        np.testing.assert_allclose(
            g[k].numpy(), ref, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(ref).max()), err_msg=k)


@pytest.mark.parametrize("name", tconfigs.ASSIGNED)
def test_loss_and_every_gradient_leaf_match_value_and_grad(name):
    jarch, tarch, npp, toks, emb = setup_train_pair(name)
    jl, jg = reference_value_and_grad(jarch, npp, toks, emb)
    tl, tg = port_loss_and_grads(tarch, npp, toks, emb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_grads_close(tg, jg)
    # every gradient is finite
    assert all(bool(torch.isfinite(t).all())
               for t in flatten_with_paths(tg).values())


def test_microbatches_must_divide_the_batch():
    _, tarch, npp, toks, emb = setup_train_pair("phi3-mini-3.8b", batch=3)
    with pytest.raises(ValueError, match="microbatches"):
        port_loss_and_grads(tarch, npp, toks, emb, microbatches=2)


FAMILIES = ["phi3-mini-3.8b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
            "recurrentgemma-9b", "whisper-small", "llava-next-34b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gives_the_gradients_of_remat_off_bit_for_bit(name,
                                                            monkeypatch):
    from repro_torch.models import layers

    calls = {}
    norm = layers.rms_norm

    def counting(*a, **kw):
        calls[remat] = calls.get(remat, 0) + 1
        return norm(*a, **kw)

    monkeypatch.setattr(layers, "rms_norm", counting)
    out = {}
    for remat in (True, False):
        _, tarch, npp, toks, emb = setup_train_pair(name, remat=remat)
        out[remat] = port_loss_and_grads(tarch, npp, toks, emb)
    assert calls[True] > calls[False]  # the backward recomputed the layers
    assert torch.equal(out[True][0], out[False][0])
    on, off = flatten_with_paths(out[True][1]), flatten_with_paths(out[False][1])
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("name,overrides", [
    ("phi3-mini-3.8b", {}),
    ("gemma3-4b", {"n_layers": 10}),  # two groups of six and a tail of four
    ("whisper-small", {}),
])
def test_forward_over_stacked_leaves_gives_the_same_gradients(name,
                                                              overrides):
    """Autograd straight through the stacked leaves (which the forward
    takes apart once with ``unbind``) and the trainer's per-layer leaves
    give the same gradients, bit for bit."""
    _, tarch, npp, toks, emb = setup_train_pair(name, **overrides)
    _, want = port_loss_and_grads(tarch, npp, toks, emb)
    params = bridge.params_from_numpy(npp, "cpu")
    flat = flatten_with_paths(params)
    for t in flat.values():
        t.requires_grad_()
    loss = ttrainer.make_loss_fn(tarch)(
        params, torch.from_numpy(toks).long(),
        None if emb is None else torch.from_numpy(emb))
    got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    want = flatten_with_paths(want)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_moe_permutations_have_the_backward_of_plain_indexing():
    """``_PermuteIn`` / ``_PermuteOut`` (gather-only backward passes) give
    the values and gradients of autograd through plain indexing, with
    dropped slots (capacity 0.5)."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(tconfigs.smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", moe_capacity=0.5)
    rng = np.random.default_rng(0)
    b, s, d, e, k = 2, 64, cfg.d_model, cfg.n_experts, cfg.topk
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((d, e)).astype(np.float32))
    _, flat_e, pos, keep = moe.route(x, router, cfg)
    assert not bool(keep.all())
    cap = moe._capacity(cfg, s)
    pos_c = pos.clamp(0, cap - 1)
    bidx = torch.arange(b)[:, None]
    slot_id = torch.full((b, e, cap), s * k, dtype=torch.long)
    for bi in range(b):
        for t in range(s * k):
            if keep[bi, t]:
                slot_id[bi, flat_e[bi, t], pos_c[bi, t]] = t
    empty = slot_id >= s * k
    slot_id_c = slot_id.clamp(max=s * k - 1)
    tok = slot_id_c // k

    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = moe._PermuteIn.apply(xa, tok, empty, flat_e, pos_c, keep, k)
    want = xb[bidx, tok.reshape(b, e * cap)].view(b, e, cap, d).masked_fill(
        empty[..., None], 0)
    assert torch.equal(got, want)
    dbuf = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    got.backward(dbuf)
    want.backward(dbuf)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)

    ob = torch.from_numpy(rng.standard_normal((e, b, cap, d))
                          .astype(np.float32))
    oa, ob2 = ob.clone().requires_grad_(), ob.clone().requires_grad_()
    got = moe._PermuteOut.apply(oa, flat_e, pos_c, keep, slot_id_c, empty)
    want = ob2[flat_e, bidx, pos_c].masked_fill(~keep[..., None], 0)
    assert torch.equal(got, want)
    dy = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    got.backward(dy)
    want.backward(dy)
    assert torch.equal(oa.grad, ob2.grad)


@pytest.mark.parametrize("axis", [None, 0])
def test_fake_quant_matches_reference_with_a_straight_through_gradient(axis):
    from repro.core import quant as jquant
    from repro_torch.core import quant as tquant

    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda a: jnp.sum(jquant.fake_quant(a, axis=axis) * w))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    fq = tquant.fake_quant(xt, axis=axis)
    np.testing.assert_array_equal(
        fq.detach().numpy(), np.asarray(jquant.fake_quant(jnp.asarray(x),
                                                          axis=axis)))
    assert not torch.equal(fq.detach(), xt.detach())  # it did quantize
    (fq * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    np.testing.assert_array_equal(np.asarray(jgrad), w)
    np.testing.assert_allclose(float((fq * torch.from_numpy(w)).sum().detach()),
                               float(jval), rtol=1e-6)
