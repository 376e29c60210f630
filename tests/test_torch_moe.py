"""PyTorch port vs JAX reference: the moe family's paged path.

The same numpy weights (``repro_torch.bridge.numpy_params``) go through
``repro.models.moe`` and ``repro_torch.models.moe`` on ``qwen3-moe-30b-a3b``
smoke configs (8 experts, top 2):

* ``_capacity`` equals the reference's over a grid of lengths, and the
  schemas agree leaf for leaf;
* the routing (experts, gates, buffer positions, kept slots) equals the
  reference's expressions, and ``moe_mlp`` is allclose with the
  reference's in float32 (1e-5: summation order only) and bfloat16 (both
  round the same f32 products to bf16; 2e-2), at ``moe_capacity`` 1.25,
  where some slots are dropped, and at ``n_experts``, where none are;
* a zero router (every probability tied) picks the experts
  ``jax.lax.top_k`` picks, the lower ones;
* ``paged_prefill``, ``paged_decode_step`` and ``paged_verify_step``
  logits are allclose at 1e-4 (float32 reordering) and every pool leaf
  agrees (int8 pools bit for bit), on float and int8 pools, for the
  all-global layout and the ``GL`` layout with a tail layer;
* a prefix-cache resume gives the reference's suffix logits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.cache import PagedLayout as JLayout
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry
from repro_torch.models.cache import PagedLayout as TLayout
from repro_torch.models.schema import leaves

from test_torch_serve import setup_pair

torch.set_num_threads(1)

NAME = "qwen3-moe-30b-a3b"
SMOKE_EXPERTS = float(tconfigs.smoke_config(NAME).n_experts)


def cfg_pair(smoke=True, **overrides):
    get = "smoke_config" if smoke else "get_config"
    return (dataclasses.replace(getattr(jconfigs, get)(NAME), **overrides),
            dataclasses.replace(getattr(tconfigs, get)(NAME), **overrides))


@pytest.mark.parametrize("smoke,capacity", [
    (True, 1.25), (True, 8.0), (True, 1.0), (False, 1.25), (False, 0.5)])
def test_capacity_matches_reference(smoke, capacity):
    jc, tc = cfg_pair(smoke=smoke, moe_capacity=capacity)
    for seq in [*range(1, 130), 255, 256, 257, 511, 512, 513, 4000, 4096]:
        assert tmoe._capacity(tc, seq) == jmoe._capacity(jc, seq), seq


@pytest.mark.parametrize("smoke,pattern,n_layers", [
    (True, "G", 2), (True, "GL", 3), (False, "G", 48)])
def test_schema_matches_reference(smoke, pattern, n_layers):
    jc, tc = cfg_pair(smoke=smoke, pattern=pattern, n_layers=n_layers)
    js, ts = jmoe.schema(jc), tmoe.schema(tc)

    def flat(tree):
        items, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes"))
        return [(jax.tree_util.keystr(path), s.shape, s.axes, s.init)
                for path, s in items]

    assert flat(ts) == flat(js)
    assert len(leaves(ts)) == len(flat(js))


def _layer_params(cfg, seed=0, zero_router=False):
    npp = bridge.numpy_params(tmoe.schema(cfg), seed=seed)
    p = {k: v[0] for k, v in npp["stacks"][0].items()}
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _reference_routing(x, router, cfg):
    """The reference ``moe_mlp``'s routing expressions, run in JAX."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.topk
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                        router.astype(jnp.float32))
    gate, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    flat_e = idx.reshape(b, s * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(onehot, 1) - 1, onehot)
    keep = (pos < jmoe._capacity(cfg, s)) & (pos >= 0)
    return [np.asarray(a) for a in (gate.reshape(b, s * k), flat_e, pos,
                                    keep)]


@pytest.mark.parametrize("dtype,capacity,zero_router", [
    ("float32", 1.25, False), ("float32", SMOKE_EXPERTS, False),
    ("bfloat16", 1.25, False), ("bfloat16", SMOKE_EXPERTS, False),
    ("float32", 1.25, True), ("float32", SMOKE_EXPERTS, True)],
    ids=lambda v: str(v))
def test_moe_mlp_matches_reference(dtype, capacity, zero_router):
    jc, tc = cfg_pair(dtype=dtype, moe_capacity=capacity)
    p = _layer_params(tc, zero_router=zero_router)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64, tc.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = tc.compute_dtype
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    # routing
    want = _reference_routing(jx, jnp.asarray(p["router"]), jc)
    got = tmoe.route(tx, torch.from_numpy(p["router"]), tc)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6,
                               atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    keep = got[3].numpy()
    if zero_router:   # ties: every token's choices are experts 0 .. k-1
        assert (got[1].numpy().reshape(3, 64, tc.topk)
                == np.arange(tc.topk)).all()
    if capacity == 1.25:
        assert not keep.all()            # the capacity binds: slots drop
    else:
        assert keep.all()
    # the FFN
    jy = jmoe.moe_mlp(jx, jax.tree.map(jnp.asarray, p), jc)
    ty = tmoe.moe_mlp(tx, {k: torch.from_numpy(v) for k, v in p.items()}, tc)
    assert ty.dtype == tdt and tuple(ty.shape) == (3, 64, tc.d_model)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Paged prefill, decode and verify steps
# ---------------------------------------------------------------------------

BLK, NBLOCKS, MAX_LEN = 8, 24, 64


def assert_pools_match(tcache, jcache, int8):
    for group in ("stacks", "tail"):
        for tc, jc in zip(tcache.get(group, ()), jcache.get(group, ())):
            assert tc.keys() == jc.keys()
            for key in tc:
                t, j = tc[key].numpy(), np.asarray(jc[key])
                if int8 or key.endswith("scale"):
                    np.testing.assert_array_equal(t, j, err_msg=key)
                else:
                    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5,
                                               err_msg=key)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def spy_routing(monkeypatch):
    """A list that collects, for every ``moe_mlp`` call, whether it kept
    all its slots."""
    kept = []
    route = tmoe.route

    def spy(*args):
        out = route(*args)
        kept.append(bool(out[3].all()))
        return out

    monkeypatch.setattr(tmoe, "route", spy)
    return kept


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("pattern,n_layers", [("G", 2), ("GL", 3)],
                         ids=["G", "GL-tail"])
def test_paged_steps_match_reference(quant, pattern, n_layers, monkeypatch):
    """Two slots prefilled at capacity 1.25 (a 52-token prompt, whose
    capacity of 16 is 1.23 times the mean load, drops slots), three decode
    steps, then two verify steps of Q = 4 at host-owned lengths (both
    slots crossing a block boundary): logits allclose, every pool leaf
    agreeing after each step."""
    jarch, jparams, tarch, tparams = setup_pair(
        NAME, quant, pattern=pattern, n_layers=n_layers)
    cfg = tarch.cfg
    assert tarch.serve_backends == ("slot", "arena", "paged")
    jcache = jarch.init_paged_cache(2, JLayout(BLK, NBLOCKS, MAX_LEN))
    tcache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                    device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (52, 9)]
    kept = spy_routing(monkeypatch)
    ids = [np.int32([3, 5, 9, 11, 14, 15, 16]), np.int32([7, 2])]
    jpre = jax.jit(jarch.paged_prefill)
    for slot, (p, bid) in enumerate(zip(prompts, ids)):
        jl, jcache = jpre(jparams, jnp.asarray(p[None]), jcache, slot,
                          jnp.asarray(bid))
        tl, tcache = tarch.paged_prefill(tparams, torch.from_numpy(p[None]),
                                         tcache, slot, torch.from_numpy(bid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    assert_pools_match(tcache, jcache, quant)
    assert not all(kept[:n_layers])        # the 52-token prefill dropped slots
    assert all(kept[2 * n_layers:])        # decode never drops
    table = np.zeros((2, MAX_LEN // BLK), np.int32)
    table[0, :7], table[1, :2] = ids[0], ids[1]
    table[0, 7], table[1, 2] = 18, 17
    backend = "interpret" if quant else "xla"
    jdec = jax.jit(functools.partial(jarch.paged_decode_step,
                                     attn_backend=backend))
    toks = np.int32([11, 22])
    for step in range(3):
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(table))
        tlog, tcache = tarch.paged_decode_step(
            tparams, tcache, torch.tensor(toks), torch.from_numpy(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4, err_msg=str(step))
        assert_pools_match(tcache, jcache, quant)
        toks = np.asarray(jnp.argmax(jlog, -1), np.int32)
    jver = jax.jit(functools.partial(jarch.paged_verify_step,
                                     attn_backend=backend))
    lens = np.int32([55, 14])
    for step in range(2):
        vt = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
        jlog, jcache = jver(jparams, dict(jcache, len=jnp.asarray(lens)),
                            jnp.asarray(vt), jnp.asarray(table))
        tcache["len"] = torch.from_numpy(lens)
        tlog, tcache = tarch.paged_verify_step(
            tparams, tcache, torch.from_numpy(vt), torch.from_numpy(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4, err_msg=str(step))
        assert_pools_match(tcache, jcache, quant)
        lens = lens + np.int32([1, 2])


@pytest.mark.parametrize("capacity", [1.25, SMOKE_EXPERTS],
                         ids=["cap1.25", "cap-n_experts"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefix_resume_matches_reference(quant, capacity):
    """A 45-token prompt prefilled into slot 0, then resumed in slot 1
    after its first three blocks: the suffix routes as a group of its own
    (capacity sized to 21 tokens) in both packages, so the logits and the
    suffix pools match the reference's resume; with the capacity at
    ``n_experts`` (no drops, float pools) they also match the full
    prefill."""
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant,
                                                moe_capacity=capacity)
    jcache = jarch.init_paged_cache(2, JLayout(BLK, NBLOCKS, MAX_LEN))
    tcache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                    device="cpu")
    prompt = np.random.default_rng(7).integers(
        0, tarch.cfg.vocab, 45).astype(np.int32)
    full_ids = np.int32([3, 5, 9, 1, 2, 4])
    prefix_ids, suffix_ids = full_ids[:3], np.int32([11, 12, 13])
    jfull, jcache = jax.jit(jarch.paged_prefill)(
        jparams, jnp.asarray(prompt[None]), jcache, 0, jnp.asarray(full_ids))
    tfull, tcache = tarch.paged_prefill(
        tparams, torch.from_numpy(prompt[None]), tcache, 0,
        torch.from_numpy(full_ids))
    jres, jcache = jax.jit(jarch.paged_prefill, static_argnames=("start",))(
        jparams, jnp.asarray(prompt[None, 24:]), jcache, 1,
        jnp.asarray(suffix_ids), prefix_ids=jnp.asarray(prefix_ids),
        start=24)
    tres, tcache = tarch.paged_prefill(
        tparams, torch.from_numpy(prompt[None, 24:]), tcache, 1,
        torch.from_numpy(suffix_ids),
        prefix_ids=torch.from_numpy(prefix_ids), start=24)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), atol=1e-4,
                               rtol=1e-4)
    assert_pools_match(tcache, jcache, quant)
    if capacity != 1.25 and not quant:
        np.testing.assert_allclose(tres.numpy(), tfull.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_registry_binds_only_the_paged_entry_points():
    """The paged entry points and the float arena ones (held to the
    reference in ``test_torch_moe_arena.py``) are bound; the family has no
    W8A8 weights and takes no right-padded prompts."""
    arch = tregistry.build(tconfigs.smoke_config(NAME))
    assert arch.serve_backends == ("slot", "arena", "paged")
    assert arch.supports_spec_decode and arch.supports_paged_int8
    assert not arch.supports_padded_prefill
    for name in ("forward", "prefill", "decode_step", "init_cache"):
        assert getattr(arch, name) is not None, name
    assert arch.quantize_params is None
    for name in ("quantize_params", "SUPPORTS_PADDED_PREFILL"):
        assert not hasattr(tmoe, name), name
