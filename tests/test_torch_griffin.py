"""PyTorch port vs JAX reference: the Griffin hybrid family
(``models/griffin.py``).

On ``recurrentgemma-9b-smoke`` (pattern ``RRL``, 2 groups, ``local_window``
16) with one numpy weight tree for both packages: ``forward`` logits,
``prefill`` logits and every cache leaf (conv tails, recurrent ``h``, ring
K/V) at prompts shorter than, equal to and longer than the window (the ring
rolled by ``s % win``), and ``decode_step`` chained for several tokens with
both sides fed the reference's greedy tokens. A variant with a tail
(``RRL RRL RR``, as the full-width 38-layer model has) runs the same.
Float32: the reference's RG-LRU is an associative scan and the port's a
sequential one, so ``rtol = atol = 1e-4`` (atol scaled by max|ref|).
Bfloat16: the frameworks round to bf16 at different places, so
``rtol = 3e-2`` and ``atol = 3e-2 · max|ref|`` (about eight bf16 ulps).

The short-prompt case (1 and 2 tokens, shorter than ``d_conv - 1``) is
anchored on the port's own ``forward``: there the reference's prefill keeps
a conv tail of fewer than ``d_conv - 1`` rows, and its ``decode_step``
raises on it (``ValueError: Size of label 'k' for operand 1 (3) does not
match previous terms (4)``, ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.models.schema import leaves

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def setup_pair(dtype, **over):
    jc = dataclasses.replace(jconfigs.smoke_config("recurrentgemma-9b"),
                             dtype=dtype, **over)
    tc = dataclasses.replace(tconfigs.smoke_config("recurrentgemma-9b"),
                             dtype=dtype, **over)
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def close(got: torch.Tensor, want, dtype, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = TOL[dtype]
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-6),
                               err_msg=what)


def leaf_pairs(t, j, name="cache"):
    """(path, port leaf, reference leaf) over the port's cache tree, the
    reference's read at the same keys and indices."""
    if isinstance(t, dict):
        assert set(t) == set(j), name
        return [x for k in t for x in leaf_pairs(t[k], j[k], f"{name}.{k}")]
    if isinstance(t, (list, tuple)):
        assert len(t) == len(j), name
        return [x for i, (tv, jv) in enumerate(zip(t, j))
                for x in leaf_pairs(tv, jv, f"{name}[{i}]")]
    return [(name, t, j)]


DTYPE_OF = {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.int32): torch.int32}


def close_caches(tcache, jcache, dtype, what):
    pairs = leaf_pairs(tcache, jcache)
    assert len(pairs) == len(leaves(tcache)) == len(jax.tree.leaves(jcache))
    for name, t, j in pairs:
        assert t.dtype == DTYPE_OF[j.dtype], name
        close(t, j, dtype, f"{what}: {name}")


@pytest.mark.parametrize("name", ["recurrentgemma-9b-smoke",
                                  "recurrentgemma-9b"])
def test_schema_matches_reference(name):
    """The ``stacks`` list of per-kind dicts and the ``tail`` come across
    unchanged: same keys, shapes (leading ``n_stack`` axis), logical axes
    and init rules — at the smoke size and at full width (12 groups, an
    ``RR`` tail), so one numpy tree feeds both packages."""
    from repro.models import griffin as jgriffin
    from repro_torch.models import griffin

    get = tconfigs.smoke_config if name.endswith("smoke") else tconfigs.get_config
    jget = jconfigs.smoke_config if name.endswith("smoke") else jconfigs.get_config
    base = name.removesuffix("-smoke")
    tsch, jsch = griffin.schema(get(base)), jgriffin.schema(jget(base))
    pairs = leaf_pairs(tsch, jsch, "schema")
    assert len(pairs) == len(jax.tree.leaves(
        jsch, is_leaf=lambda x: hasattr(x, "axes")))
    for path, t, j in pairs:
        assert (t.shape, t.axes, t.init, t.scale) == (
            tuple(j.shape), tuple(j.axes), j.init, j.scale), path
    if not name.endswith("smoke"):
        assert [st["w_x"].shape[0] for st in tsch["stacks"]
                if "w_x" in st] == [12, 12]
        assert [st["w_x"].shape[0] for st in tsch["tail"]] == [1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [5, 16, 21])
def test_forward_prefill_and_decode_match_reference(dtype, s):
    """s < win, s = win and s > win with s % win ≠ 0 (win = 16)."""
    jarch, jparams, tarch, tparams = setup_pair(dtype)
    rng = np.random.default_rng(s)
    toks = rng.integers(0, tarch.cfg.vocab, (2, s)).astype(np.int32)
    close(tarch.forward(tparams, torch.from_numpy(toks)),
          jarch.forward(jparams, jnp.asarray(toks)), dtype, "forward")

    jlog, jcache = jarch.prefill(jparams, jnp.asarray(toks), 32)
    tlog, tcache = tarch.prefill(tparams, torch.from_numpy(toks), 32)
    close(tlog, jlog, dtype, "prefill logits")
    close_caches(tcache, jcache, dtype, "prefill")
    np.testing.assert_array_equal(tcache["len"].numpy(), [s, s])

    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    for step in range(3):
        jlog, jcache = jarch.decode_step(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tarch.decode_step(tparams, tcache,
                                         torch.from_numpy(tok.copy()))
        close(tlog, jlog, dtype, f"decode {step}")
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    close_caches(tcache, jcache, dtype, "after decode")
    np.testing.assert_array_equal(tcache["len"].numpy(), [s + 3, s + 3])


def test_layer_tail_matches_reference():
    """Eight layers: two ``RRL`` groups and an ``RR`` tail, whose parameters
    and cache carry a leading axis of 1 (recurrentgemma-9b is 12 groups and
    an ``RR`` tail)."""
    jarch, jparams, tarch, tparams = setup_pair("float32", n_layers=8)
    assert tarch.cfg.layer_layout() == ("RRL", 2, "RR")
    assert [tuple(p["w_x"].shape[:1]) for p in tparams["tail"]] == [(1,), (1,)]
    toks = np.random.default_rng(4).integers(
        0, tarch.cfg.vocab, (1, 19)).astype(np.int32)
    close(tarch.forward(tparams, torch.from_numpy(toks)),
          jarch.forward(jparams, jnp.asarray(toks)), "float32", "forward")
    jlog, jcache = jarch.prefill(jparams, jnp.asarray(toks), 32)
    tlog, tcache = tarch.prefill(tparams, torch.from_numpy(toks), 32)
    close(tlog, jlog, "float32", "prefill logits")
    close_caches(tcache, jcache, "float32", "prefill")
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    for step in range(3):
        jlog, jcache = jarch.decode_step(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tarch.decode_step(tparams, tcache,
                                         torch.from_numpy(tok.copy()))
        close(tlog, jlog, "float32", f"decode {step}")
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    close_caches(tcache, jcache, "float32", "after decode")


@pytest.mark.parametrize("n_prompt", [1, 2])
def test_short_prompt_prefill_decode_equals_own_forward(n_prompt):
    """Prompts shorter than the conv tail: prefill (tail left-padded with
    the conv's own zeros) plus greedy decode gives, token for token, the
    argmax of ``forward`` over the prompt and the tokens so far — past the
    16-token window, so the ring wraps."""
    _, _, tarch, tparams = setup_pair("float32")
    prompt = np.int32([7, 9][:n_prompt])
    logits, cache = tarch.prefill(tparams, torch.from_numpy(prompt[None]),
                                  32)
    assert cache["stacks"][0]["conv"].shape[2] == tarch.cfg.d_conv - 1
    seq = list(prompt)
    for _ in range(18):
        want = tarch.forward(tparams, torch.tensor([seq]))[0, -1]
        torch.testing.assert_close(logits[0], want, rtol=1e-4, atol=1e-4)
        tok = int(torch.argmax(logits[0]))
        assert tok == int(torch.argmax(want))
        seq.append(tok)
        logits, cache = tarch.decode_step(tparams, cache,
                                          torch.tensor([tok]))


def test_cache_insert_matches_reference():
    """A prefilled batch-1 nested cache spliced into slot 1 of a 3-slot
    arena, in place, as the reference's tree-mapped ``cache_insert``
    splices it; a cache of another window or batch is refused."""
    from repro.models.cache import cache_insert as jinsert
    from repro_torch.models.cache import batch_axis, cache_insert

    jarch, jparams, tarch, tparams = setup_pair("float32")
    toks = np.int32([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]])
    _, jsingle = jarch.prefill(jparams, jnp.asarray(toks), 32)
    _, tsingle = tarch.prefill(tparams, torch.from_numpy(toks), 32)
    jcache = jinsert(jarch.init_cache(3, 32), jsingle, 1)
    tcache = tarch.init_cache(3, 32, device="cpu")
    assert cache_insert(tcache, tsingle, 1) is tcache
    for leaf in leaves(tcache):
        assert batch_axis(leaf) == (0 if leaf.dim() == 1 else 1)
    close_caches(tcache, jcache, "float32", "insert")
    assert float(tcache["stacks"][2]["k"][:, [0, 2]].abs().max()) == 0.0
    with pytest.raises(ValueError, match=r"stacks\[2\]\.k .*does not fit"):
        cache_insert(tcache, tarch.prefill(tparams, torch.from_numpy(toks),
                                           8)[1], 0)
    with pytest.raises(ValueError, match="does not fit"):
        cache_insert(tcache, tarch.init_cache(2, 32, device="cpu"), 0)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_matches_reference(ring):
    """Per-row lengths below, at and past the cache length (a ring clamps
    them to it), with grouped query heads over unexpanded KV heads."""
    from repro.models.attention import decode_attention as jdecode_attention
    from repro_torch.models.attention import decode_attention

    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((4, 2, 8, 16)).astype(np.float32)
    v = rng.standard_normal((4, 2, 8, 16)).astype(np.float32)
    lens = np.int32([1, 5, 8, 8 if not ring else 13])
    want = jdecode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), ring=ring, expand_kv=False)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["L", "G"])
def test_cache_write_matches_reference(kind):
    """One token per row at per-row positions: a ring ("L") writes at
    ``pos % S_len``, a global layer clamps at the last row."""
    from repro.models.transformer import _cache_write as jcache_write
    from repro_torch.models.transformer import _cache_write

    rng = np.random.default_rng(6)
    c = {n: rng.standard_normal((3, 1, 8, 4)).astype(np.float32)
         for n in ("k", "v")}
    kn = rng.standard_normal((3, 1, 1, 4)).astype(np.float32)
    vn = rng.standard_normal((3, 1, 1, 4)).astype(np.float32)
    pos = np.int32([2, 8, 19])
    want = jcache_write({n: jnp.asarray(a) for n, a in c.items()},
                        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
                        kind, None)
    tc = {n: torch.from_numpy(a.copy()) for n, a in c.items()}
    assert _cache_write(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(pos), kind, None) is tc
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(want[n]))
