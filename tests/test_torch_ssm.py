"""PyTorch port vs JAX reference: the Mamba-2 family (``models/ssm.py``).

On ``mamba2-2.7b-smoke`` with one numpy weight tree for both packages:
``forward`` logits, ``prefill`` logits with the conv tail and SSD state,
and ``decode_step`` chained for six tokens (both sides fed the reference's
greedy tokens). Float32: the two scans add in different orders, so
``rtol = atol = 1e-4`` (logits scaled by their max). Bfloat16: the two
frameworks round to bf16 at different places (the einsum reductions), so
``rtol = 3e-2`` and ``atol = 3e-2 · max|ref|`` (about eight bf16 ulps).

The short-prompt case (prompts of 1 and 2 tokens, shorter than
``d_conv - 1``) is anchored on the port's own ``forward``: the reference's
prefill keeps a short conv tail there that its arena misplaces (ROADMAP
Queue C), so it is not the anchor.
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

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def setup_pair(dtype):
    jc = dataclasses.replace(jconfigs.smoke_config("mamba2-2.7b"),
                             dtype=dtype)
    tc = dataclasses.replace(tconfigs.smoke_config("mamba2-2.7b"),
                             dtype=dtype)
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def close(got: torch.Tensor, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_reference(dtype):
    jarch, jparams, tarch, tparams = setup_pair(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tarch.cfg.vocab, (2, 37)).astype(np.int32)
    close(tarch.forward(tparams, torch.from_numpy(toks)),
          jarch.forward(jparams, jnp.asarray(toks)), dtype, "forward")

    jlog, jcache = jarch.prefill(jparams, jnp.asarray(toks), 64)
    tlog, tcache = tarch.prefill(tparams, torch.from_numpy(toks), 64)
    close(tlog, jlog, dtype, "prefill logits")
    assert tcache["conv"].dtype == tarch.cfg.compute_dtype
    assert tuple(tcache["conv"].shape) == jcache["conv"].shape
    close(tcache["conv"], jcache["conv"], dtype, "conv tail")
    close(tcache["ssd"], jcache["ssd"], dtype, "ssd state")
    np.testing.assert_array_equal(tcache["len"].numpy(), [37, 37])

    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    for step in range(6):
        jlog, jcache = jarch.decode_step(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tarch.decode_step(tparams, tcache,
                                         torch.from_numpy(tok.copy()))
        close(tlog, jlog, dtype, f"decode {step}")
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    close(tcache["ssd"], jcache["ssd"], dtype, "ssd state after decode")
    close(tcache["conv"], jcache["conv"], dtype, "conv tail after decode")
    np.testing.assert_array_equal(tcache["len"].numpy(), [43, 43])


@pytest.mark.parametrize("n_prompt", [1, 2])
def test_short_prompt_prefill_decode_equals_own_forward(n_prompt):
    """Prompts shorter than the conv tail: prefill (tail left-padded with
    the conv's own zeros) plus greedy decode gives, token for token, the
    argmax of ``forward`` over the prompt and the tokens so far."""
    _, _, tarch, tparams = setup_pair("float32")
    prompt = np.int32([7, 9][:n_prompt])
    logits, cache = tarch.prefill(tparams, torch.from_numpy(prompt[None]),
                                  32)
    assert tuple(cache["conv"].shape[2:3]) == (tarch.cfg.d_conv - 1,)
    seq = list(prompt)
    for _ in range(6):
        want = tarch.forward(tparams, torch.tensor([seq]))[0, -1]
        torch.testing.assert_close(logits[0], want, rtol=1e-4, atol=1e-4)
        tok = int(torch.argmax(logits[0]))
        assert tok == int(torch.argmax(want))
        seq.append(tok)
        logits, cache = tarch.decode_step(tparams, cache,
                                          torch.tensor([tok]))


def test_prefill_tail_equals_reference_from_three_tokens():
    """From ``d_conv - 1`` tokens on, the left-padded tail is exactly the
    reference's ``xbc_raw[:, -k:]``."""
    jarch, jparams, tarch, tparams = setup_pair("float32")
    toks = np.int32([[7, 9, 11]])
    _, jcache = jarch.prefill(jparams, jnp.asarray(toks), 32)
    _, tcache = tarch.prefill(tparams, torch.from_numpy(toks), 32)
    close(tcache["conv"], jcache["conv"], "float32")
    close(tcache["ssd"], jcache["ssd"], "float32")


def test_cache_insert_matches_reference():
    """A prefilled batch-1 cache spliced into slot 1 of a 3-slot arena, in
    place, as the reference's functional ``cache_insert`` splices it."""
    from repro.models.cache import cache_insert as jinsert
    from repro_torch.models.cache import batch_axis, cache_insert

    jarch, jparams, tarch, tparams = setup_pair("float32")
    toks = np.int32([[3, 1, 4, 1, 5]])
    _, jsingle = jarch.prefill(jparams, jnp.asarray(toks), 32)
    _, tsingle = tarch.prefill(tparams, torch.from_numpy(toks), 32)
    jcache = jinsert(jarch.init_cache(3, 32), jsingle, 1)
    tcache = tarch.init_cache(3, 32, device="cpu")
    assert cache_insert(tcache, tsingle, 1) is tcache
    for name in ("conv", "ssd", "len"):
        assert batch_axis(tcache[name]) == (0 if name == "len" else 1)
        close(tcache[name], jcache[name], "float32", name)
    with pytest.raises(ValueError, match="does not fit"):
        cache_insert(tcache, tarch.init_cache(2, 32, device="cpu"), 0)
