"""PyTorch port vs JAX reference: content-addressed prefix caching on the
paged backend.

* ``gather_prefix_kv`` equals the reference's (float pools exactly; int8
  pools dequantized by their per-block scales).
* A suffix-resume ``paged_prefill`` (``prefix_ids``/``start``) gives the
  reference's logits at 1e-4 and, in float32, the full prefill's.
* End to end, the port's greedy streams with the prefix cache on equal the
  (synchronised) JAX engine's, float and int8 pools (int8 anchored on
  ``attn_backend="interpret"``), with the same hit and skip counters; the
  pool partition free ⊎ live ⊎ cached holds after every step.
* With speculative decoding on top (``spec_tokens`` in {1, 3}) the port
  still gives the JAX engine's streams and counters.
* Copy-on-write: a forked (shared) tail block is copied before the next
  write, bit for bit, and the stream is unchanged.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cache import PagedLayout as JLayout
from repro.models.cache import gather_prefix_kv as j_gather_prefix_kv
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch.models.cache import PagedLayout as TLayout
from repro_torch.models.cache import gather_prefix_kv
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_serve import CONFIGS, setup_pair, sync_reference_decode
from test_torch_spec import (
    ENGINE_KW, assert_partition, spec_identity_cell, spec_prompts,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_gather_prefix_kv_matches_reference(int8):
    rng = np.random.default_rng(0)
    shape = (9, 2, 8, 16)
    if int8:
        pool = rng.integers(-127, 128, shape).astype(np.int8)
        scale = rng.uniform(0.01, 0.05, shape[0]).astype(np.float32)
    else:
        pool = rng.standard_normal(shape).astype(np.float32)
        scale = None
    ids = np.int32([5, 2, 7])
    t = gather_prefix_kv(torch.from_numpy(pool), torch.from_numpy(ids),
                         None if scale is None else torch.from_numpy(scale))
    j = j_gather_prefix_kv(jnp.asarray(pool), jnp.asarray(ids),
                           None if scale is None else jnp.asarray(scale))
    assert tuple(t.shape) == (1, 2, 24, 16)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if int8:
        with pytest.raises(ValueError, match="per-block scales"):
            gather_prefix_kv(torch.from_numpy(pool), torch.from_numpy(ids))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_suffix_resume_prefill_logits_allclose(quant):
    """Prefill 16 prompt positions (two blocks) into slot 0, then resume the
    same prompt in slot 1 from those blocks: the suffix logits match the
    reference's resume, and (float) the full prefill's."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", quant)
    blk, nblocks, max_len = 8, 20, 64
    jcache = jarch.init_paged_cache(2, JLayout(blk, nblocks, max_len))
    tcache = tarch.init_paged_cache(2, TLayout(blk, nblocks, max_len),
                                    device="cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, tarch.cfg.vocab, 21).astype(np.int32)
    full_ids, prefix_ids, suffix_ids = (np.int32([3, 5, 9]), np.int32([3, 5]),
                                        np.int32([11, 12]))
    jfull, jcache = jax.jit(jarch.paged_prefill)(
        jparams, jnp.asarray(prompt[None]), jcache, 0, jnp.asarray(full_ids))
    tfull, tcache = tarch.paged_prefill(
        tparams, torch.from_numpy(prompt[None]), tcache, 0,
        torch.from_numpy(full_ids))
    padded = np.zeros((1, 16), np.int32)
    padded[0, :5] = prompt[16:]
    jres, jcache = jax.jit(jarch.paged_prefill, static_argnames=("start",))(
        jparams, jnp.asarray(padded), jcache, 1, jnp.asarray(suffix_ids),
        true_len=jnp.int32(21), prefix_ids=jnp.asarray(prefix_ids), start=16)
    tres, tcache = tarch.paged_prefill(
        tparams, torch.from_numpy(padded), tcache, 1,
        torch.from_numpy(suffix_ids), true_len=21,
        prefix_ids=torch.from_numpy(prefix_ids), start=16)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    if not quant:  # the resume attends the same float K/V the full pass did
        np.testing.assert_allclose(tres.numpy(), tfull.numpy(), atol=1e-4,
                                   rtol=1e-4)
    # the suffix block holds what the full prefill wrote at those positions
    # (int8: deeper layers attend the dequantized prefix, so only the first
    # layer's K, a function of the embeddings alone, is bit-equal)
    k = tcache["stacks"][0]["k"]
    if quant:
        assert torch.equal(k[0, 11, :, :5], k[0, 9, :, :5])
    else:
        torch.testing.assert_close(k[:, 11, :, :5], k[:, 9, :, :5],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_prefix_cache_greedy_identity_with_reference(name, quant):
    jarch, jparams, tarch, tparams = setup_pair(name, quant)
    kw = dict(ENGINE_KW, prefix_cache=True)
    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **kw)))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **kw),
                   device="cpu")
    prompts = spec_prompts(tarch.cfg.vocab, seed=2)
    jh = [je.add_request(p, max_new_tokens=10) for p in prompts]
    th = [te.add_request(p, max_new_tokens=10) for p in prompts]
    je.run_until_drained()
    while not te.idle:
        te.step()
        assert_partition(te)
    assert [te.request(h).output for h in th] == \
        [je.request(h).output for h in jh]
    assert [te.request(h).preemptions for h in th] == \
        [je.request(h).preemptions for h in jh]
    m, jm = te.metrics(), je.metrics()
    for key in ("prefix_cache_hit_blocks", "prefix_cache_miss_blocks",
                "prefill_tokens_total", "prefill_tokens_skipped",
                "prefix_cached_blocks", "prefix_cache_evictions"):
        assert m[key] == jm[key], key
    assert m["prefix_cache_hit_rate"] > 0 and m["prefill_skip_rate"] > 0
    assert te.alloc.live_blocks == 0 and te.alloc.cached_blocks > 0


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", CONFIGS)
def test_spec_with_prefix_cache_greedy_identity_with_reference(name, k,
                                                               quant):
    spec_identity_cell(name, k, quant, prefix=True)


def test_float_cache_on_equals_cache_off_and_memo_hygiene():
    """Float32: resuming from cached blocks is greedy-identical to
    recomputing them; aborting a queued request forgets its chain keys."""
    _, _, tarch, tparams = setup_pair("phi3-mini-3.8b", False)
    prompts = spec_prompts(tarch.cfg.vocab, seed=5)
    outs = {}
    for on in (False, True):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend="paged", **ENGINE_KW, prefix_cache=on), device="cpu")
        hs = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.run_until_drained()
        outs[on] = [eng.request(h).output for h in hs]
    assert outs[True] == outs[False]
    assert eng.metrics()["prefill_tokens_skipped"] > 0
    h = eng.add_request(prompts[0], max_new_tokens=4)
    assert eng.backend.can_admit(eng.request(h))   # keys memoised here
    assert h in eng.backend._key_memo
    eng.abort(h)
    assert h not in eng.backend._key_memo


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_copy_on_write_of_a_shared_tail_block(quant):
    """Fork a running slot's tail block (an extra reference, as a sharer
    would hold): the next iteration copies it bit for bit into a private
    block before writing, the fork keeps its contents, and the stream is
    the unforked one."""
    _, _, tarch, tparams = setup_pair("glm4-9b", quant)
    prompt = spec_prompts(tarch.cfg.vocab, n=1, seed=6)[0][:13]

    def run(fork):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend="paged", **ENGINE_KW, prefix_cache=True), device="cpu")
        h = eng.add_request(prompt, max_new_tokens=8)
        eng.step()                                # admission
        eng.step()                                # one decode
        if fork:
            b = eng.backend
            n = b._slot_len[0]
            old = int(b.table[0, n // ENGINE_KW["block_len"]])
            eng.alloc.incref(old)
            pool = eng.cache["stacks"][0]["k"]
            before = pool[:, old].clone()
            eng.step()
            new = int(b.table[0, n // ENGINE_KW["block_len"]])
            assert new != old and eng.alloc.cow_copies == 1
            off = n % ENGINE_KW["block_len"]
            assert torch.equal(pool[:, new, :, :off], before[:, :, :off])
            assert torch.equal(pool[:, old], before)   # the fork is intact
            eng.alloc.decref(old)
        eng.run_until_drained()
        assert eng.alloc.live_blocks == 0
        assert_partition(eng)
        return eng.request(h).output

    assert run(True) == run(False)
