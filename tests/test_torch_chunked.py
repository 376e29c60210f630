"""PyTorch port vs JAX reference: chunked prefill on the paged backend.

* Greedy streams, preemptions and the chunk / prefix counters of the port
  equal the synchronised JAX engine's with the same ``prefill_chunk_tokens``
  (int8 pools anchored on ``attn_backend="interpret"``, the kernel
  contract). The cells cover chunks of 1, 2 and 4 blocks on float and on
  int8 pools, prefix cache off and on, on ``glm4-9b-smoke`` and
  ``phi3-mini-3.8b-smoke``, and one cell with ``spec_tokens=2``.
* Within the port, chunked streams equal monolithic ones on float pools for
  any workload. On int8 pools a chunk boundary is a suffix resume (the next
  chunk attends the dequantized int8 K/V its predecessor wrote, where a
  monolithic prefill attends float K/V), the near-tie class of the
  reference's ``tests/test_serve_chunked.py`` note: identity holds on the
  pinned workloads below.
* The bounded iteration, as the reference's ``test_serve_chunked.py``
  tests it: decode progress during a long chunked prefill, the stall
  counter, a mid-chunk abort returning every block, the chain-key memo
  forgotten after a queue abort and after a finish with no slot, and a
  seeded randomised interleave holding the allocator partition every step.
* ``metrics()`` keys and the ``prefill_chunk_tokens`` validation errors
  equal the reference's.
"""

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch.models.cache import prefix_chain_keys
from repro_torch.serve import EngineConfig, LLMEngine, Request, RequestState

from test_torch_serve import setup_pair, sync_reference_decode
from test_torch_spec import (
    BLK, ENGINE_KW, assert_frontier_blocks, assert_partition, spec_prompts,
)

torch.set_num_threads(1)

# metrics read off the host clock differ run to run
CLOCKED = ("wall", "jitter")


def shared_metrics_equal(m, jm):
    assert set(m) == set(jm)
    for key in m:
        if not any(c in key for c in CLOCKED):
            assert m[key] == jm[key], key


@pytest.mark.parametrize("name,quant,chunk,prefix,spec", [
    ("glm4-9b", False, 1, False, 0),
    ("glm4-9b", False, 4, True, 0),
    ("glm4-9b", True, 2, True, 0),
    ("glm4-9b", True, 4, False, 0),
    ("phi3-mini-3.8b", False, 2, True, 0),
    ("phi3-mini-3.8b", True, 1, False, 0),
    ("glm4-9b", True, 2, True, 2),
], ids=lambda v: str(v))
def test_chunked_greedy_identity_with_reference(name, quant, chunk, prefix,
                                                spec):
    jarch, jparams, tarch, tparams = setup_pair(name, quant)
    kw = dict(ENGINE_KW, prefill_chunk_tokens=chunk * BLK,
              prefix_cache=prefix, spec_tokens=spec)
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
        assert_frontier_blocks(te)
    assert [te.request(h).output for h in th] == \
        [je.request(h).output for h in jh]
    assert [te.request(h).preemptions for h in th] == \
        [je.request(h).preemptions for h in jh]
    m, jm = te.metrics(), je.metrics()
    shared_metrics_equal(m, jm)
    # the prompts span 3-5 blocks: chunking took place
    assert m["prefill_chunks_dispatched"] > len(prompts)
    if prefix:
        assert m["prefix_cache_hit_blocks"] > 0
    if spec:
        assert m["spec_drafted"] > 0
    assert te.alloc.live_blocks == 0


@pytest.fixture(scope="module")
def port_float():
    _, _, tarch, tparams = setup_pair("phi3-mini-3.8b", False)
    return tarch, tparams


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _serve(tarch, tparams, prompts, chunk, sample=False, **kw):
    """Every third request sampled when ``sample`` (a token is a function
    of the seed, the rid and its output index, chunked or not)."""
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=3, max_len=64, block_len=BLK,
        prefill_chunk_tokens=chunk, seed=5, **kw), device="cpu")
    hs = [eng.add_request(p, max_new_tokens=6, rid=i, top_k=20,
                          temperature=0.9 if sample and i % 3 == 2 else None)
          for i, p in enumerate(prompts)]
    while not eng.idle:
        eng.step()
        assert_partition(eng)
        # one decode pass and one fetch an iteration, chunking or not
        assert eng.decode_dispatches <= eng.iterations
        assert eng.transfers <= eng.iterations
    assert eng.alloc.live_blocks == 0
    return eng, [eng.request(h).output for h in hs]


@pytest.mark.parametrize("prefix", [False, True], ids=["cache-off",
                                                      "cache-on"])
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_float_chunked_equals_monolithic(port_float, chunk, prefix):
    tarch, tparams = port_float
    rng = np.random.default_rng(chunk)
    shared = _prompt(tarch.cfg.vocab, 2 * BLK, seed=99)
    prompts = [np.concatenate([shared, _prompt(
        tarch.cfg.vocab, int(rng.integers(1, 30)), seed=i)])
        if i % 2 else _prompt(tarch.cfg.vocab, int(rng.integers(3, 50)), i)
        for i in range(6)]
    _, base = _serve(tarch, tparams, prompts, None, sample=True,
                     prefix_cache=prefix)
    eng, out = _serve(tarch, tparams, prompts, chunk * BLK, sample=True,
                      prefix_cache=prefix)
    assert out == base
    assert eng.backend.prefill_chunk_dispatches > len(prompts)
    if prefix:
        assert eng.prefill_tokens_skipped >= 2 * BLK


@pytest.mark.parametrize("prefix", [False, True], ids=["cache-off",
                                                      "cache-on"])
@pytest.mark.parametrize("name", ["glm4-9b", "phi3-mini-3.8b"])
def test_int8_chunked_equals_monolithic_on_pinned_workloads(name, prefix):
    """The pinned workload: a two-block system prompt and 10–25-token
    suffixes (seed 8), chunks of two blocks."""
    _, _, tarch, tparams = setup_pair(name, True)
    sys_prompt = (np.arange(2 * BLK) % tarch.cfg.vocab).astype(np.int32)
    rng = np.random.default_rng(8)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, tarch.cfg.vocab, int(rng.integers(10, 26))).astype(np.int32)])
        for _ in range(4)]
    _, base = _serve(tarch, tparams, prompts, None, prefix_cache=prefix)
    eng, out = _serve(tarch, tparams, prompts, 2 * BLK, prefix_cache=prefix)
    assert out == base
    assert eng.backend.prefill_chunk_dispatches > len(prompts)


def test_decode_progress_during_long_chunked_prefill(port_float):
    """A running decode gains one token every iteration while a 41-token
    prompt prefills a block at a time beside it."""
    tarch, tparams = port_float
    vocab = tarch.cfg.vocab
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=2, max_len=64, block_len=BLK,
        prefill_chunk_tokens=BLK),
        device="cpu")
    h0 = eng.add_request(_prompt(vocab, 5, seed=0), max_new_tokens=12)
    eng.step()
    r0 = eng.request(h0)
    assert r0.state == RequestState.RUNNING and len(r0.output) == 1
    h1 = eng.add_request(_prompt(vocab, 41, seed=1), max_new_tokens=4)
    r1 = eng.request(h1)
    mid_chunk_iters = 0
    while r1.state != RequestState.RUNNING:
        before, pos = len(r0.output), r1.prefill_pos
        eng.step()
        assert len(r0.output) == before + 1      # decode never stalls
        if r1.state == RequestState.PREFILL:
            mid_chunk_iters += 1
            assert len(r1.output) == 0
            assert r1.prefill_pos % BLK == 0
            assert 0 < r1.prefill_pos - pos <= BLK
            assert eng.metrics()["prefill_chunks_in_flight"] == 1.0
            # the mid-chunk slot's table row stays at the trash block
            assert not eng.backend.table[eng.slots.index(r1)].any()
    assert mid_chunk_iters >= 4
    assert len(r1.output) == 1
    eng.run_until_drained()
    assert len(r0.output) == 12 and len(r1.output) == 4


def test_chunk_budget_stall_counter(port_float):
    """Under a one-block budget the continuation of one long admission
    takes the whole budget: the queued request waits and a stall counts."""
    tarch, tparams = port_float
    vocab = tarch.cfg.vocab
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=2, max_len=64, block_len=BLK,
        prefill_chunk_tokens=BLK, admit_batch=2), device="cpu")
    eng.add_request(_prompt(vocab, 41, seed=0), max_new_tokens=3, rid=0)
    eng.step()
    eng.add_request(_prompt(vocab, 41, seed=1), max_new_tokens=3, rid=1)
    eng.step()
    assert eng.request(1).state == RequestState.WAITING
    assert eng.metrics()["prefill_chunk_stalls"] >= 1.0
    done = eng.run_until_drained()
    assert sorted(len(r.output) for r in done) == [3, 3]
    assert_partition(eng)


def test_abort_mid_chunk_returns_every_block(port_float):
    tarch, tparams = port_float
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=2, max_len=64, block_len=BLK,
        prefill_chunk_tokens=BLK),
        device="cpu")
    free0 = eng.alloc.free_blocks
    h = eng.add_request(_prompt(tarch.cfg.vocab, 41), max_new_tokens=4)
    eng.step()
    req = eng.request(h)
    assert req.state == RequestState.PREFILL and req.prefill_pos == BLK
    assert eng.alloc.live_blocks > 0 and eng.backend._chunk
    assert eng.abort(h)
    assert eng.alloc.free_blocks == free0
    assert eng.alloc.live_blocks == 0
    assert not eng.backend._chunk and req.prefill_pos == 0
    assert_partition(eng)
    assert eng.idle


def test_queue_abort_forgets_chain_key_memo(port_float):
    """A queued request's chain keys are memoised by ``can_admit``; an abort
    before admission never reaches ``release``, so ``forget`` drops them
    and a reused rid with another prompt of the same length gets fresh
    keys."""
    tarch, tparams = port_float
    vocab = tarch.cfg.vocab
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=2, max_len=64, block_len=BLK,
        prefix_cache=True, num_blocks=8, prefill_chunk_tokens=2 * BLK),
        device="cpu")
    eng.add_request(_prompt(vocab, 9, seed=0), max_new_tokens=8, rid=0)
    eng.step()                                    # rid 0 admitted whole
    p_old = _prompt(vocab, 33, seed=1)
    # rid 77's reservation (7 blocks) exceeds what rid 0 leaves free: a
    # can_admit refusal queues it, and seeds the memo
    eng.add_request(p_old, max_new_tokens=22, rid=77)
    eng.step()
    assert eng.request(77).state == RequestState.WAITING
    assert 77 in eng.backend._key_memo
    assert eng.abort(77)
    assert 77 not in eng.backend._key_memo
    p_new = _prompt(vocab, 33, seed=2)
    eng.add_request(p_new, max_new_tokens=22, rid=77)
    assert eng.backend._chain_keys(eng.request(77)) == \
        prefix_chain_keys(p_new, BLK)
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done if r.state == RequestState.DONE) == \
        [0, 77]
    assert_partition(eng)


def test_finish_without_slot_forgets_memo(port_float):
    tarch, tparams = port_float
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=2, max_len=64, block_len=BLK, prefix_cache=True,
        prefill_chunk_tokens=BLK), device="cpu")
    req = Request(rid=5, prompt=_prompt(tarch.cfg.vocab, 9),
                  max_new_tokens=2)
    eng.submit(req)
    eng.backend._chain_keys(req)
    assert 5 in eng.backend._key_memo
    eng.queue.remove(req)
    eng._finish(req, None, "stop", 0.0, True, [])
    assert 5 not in eng.backend._key_memo


def test_randomized_chunked_interleave_partition_invariant(port_float):
    """150 seeded iterations on the qos scheduler: multi-chunk admissions
    (shared prefixes, so cache hits shorten chunk lists), random aborts
    (mid-chunk too) and rt forced admissions preempting be slots. The
    partition free ⊎ live ⊎ cached == usable holds after every step, and a
    mid-chunk abort returns its blocks at once."""
    tarch, tparams = port_float
    vocab = tarch.cfg.vocab
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="paged", slots=3, max_len=64, block_len=BLK, prefix_cache=True,
        prefill_chunk_tokens=BLK, scheduler="qos", rt_window=1),
        device="cpu")
    rng = np.random.default_rng(42)
    shared = (np.arange(2 * BLK) % vocab).astype(np.int32)
    rid, live, mid_chunk_aborts = 0, [], 0
    for _ in range(150):
        while len(live) < 6:
            n = int(rng.choice([5, 9, 17, 25, 33]))
            prompt = _prompt(vocab, n, seed=rid)
            if rng.random() < 0.5 and n > 2 * BLK:
                prompt = np.concatenate([shared, prompt[:n - 2 * BLK]])
            qos = "rt" if rng.random() < 0.3 else "be"
            live.append(eng.add_request(
                prompt, qos=qos, rid=rid, max_new_tokens=int(rng.choice(
                    [3, 6, 12] if qos == "be" else [3, 4]))))
            rid += 1
        if rng.random() < 0.15:
            victim = eng.request(live[int(rng.integers(len(live)))])
            was_mid_chunk = victim.state == RequestState.PREFILL
            before = eng.alloc.live_blocks
            if eng.abort(victim) and was_mid_chunk:
                mid_chunk_aborts += 1
                assert eng.alloc.live_blocks < before
        eng.step()
        assert_partition(eng)
        live = [h for h in live if not eng.request(h).finished]
    done = eng.run_until_drained()
    assert_partition(eng)
    assert eng.alloc.live_blocks == 0
    assert mid_chunk_aborts >= 1
    assert eng.backend.prefill_chunk_dispatches > 20
    assert eng.alloc.hit_blocks > 0
    assert any(r.preemptions > 0 for r in eng._requests.values())
    for r in done:
        if r.state == RequestState.DONE:
            assert len(r.output) == r.max_new_tokens


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prefill_chunk_tokens=BLK),
    dict(prefill_chunk_tokens=2 * BLK, prefix_cache=True),
    dict(prefill_chunk_tokens=BLK, spec_tokens=2, scheduler="qos"),
], ids=["monolithic", "chunked", "chunked-prefix", "chunked-spec-qos"])
def test_metrics_keys_equal_reference(kw):
    """On a fresh engine (every value 0, no division by an empty window)
    and after one admission step."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", False)
    ec = dict(ENGINE_KW, **kw)
    je = JEngine(jarch, jparams, JEngineConfig(backend="paged", **ec))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **ec),
                   device="cpu")
    m, jm = te.metrics(), je.metrics()
    assert set(m) == set(jm)
    assert all(v == 0.0 for v in m.values())
    te.add_request(_prompt(tarch.cfg.vocab, 20), max_new_tokens=4)
    te.step()
    assert set(te.metrics()) == set(jm)


@pytest.mark.parametrize("block_len,chunk", [(16, 12), (16, 8), (8, 0),
                                             (8, -8), (8, 20)])
def test_prefill_chunk_tokens_validation_matches_reference(block_len, chunk):
    with pytest.raises(ValueError) as want:
        JEngineConfig(backend="paged", block_len=block_len,
                      prefill_chunk_tokens=chunk)
    with pytest.raises(ValueError) as got:
        EngineConfig(backend="paged", block_len=block_len,
                     prefill_chunk_tokens=chunk)
    assert str(got.value) == str(want.value)
    assert EngineConfig(backend="paged", block_len=16, prefill_chunk_tokens=32
                        ).prefill_chunk_tokens == 32


def test_chunking_off_the_paged_backend_matches_reference():
    """Chunked prefill resumes at block boundaries of the shared pool: the
    arena refuses it with the reference's words, before any weight is
    read; a mesh and a ring layout stay refused by name with chunking on
    (``test_torch_serve.test_mesh_and_ring_layouts_raise_by_name``)."""
    ec = dict(backend="arena", block_len=16, prefill_chunk_tokens=16)
    with pytest.raises(ValueError) as want:
        JEngine(None, None, JEngineConfig(**ec))
    with pytest.raises(ValueError) as got:
        LLMEngine(None, None, EngineConfig(**ec), device="cpu")
    assert str(got.value) == str(want.value)
    assert "paged backend only" in str(got.value)
