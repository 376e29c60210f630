"""PyTorch port vs JAX reference: the encdec family served end to end.

Greedy streams of the port's ``LLMEngine`` against the synchronised JAX
engine (``test_torch_serve.sync_reference_decode``) on
``whisper-small-smoke`` in float32 — each request carrying its own
``[enc_seq, d_model]`` frame embeddings (``embeds``), two clips shared by
several requests whose decoder prompts share a two-block prefix:

* paged, float and int8 pools (int8 against the reference's
  ``attn_backend="interpret"``, the kernel contract), prefix cache off and
  on (the chain salt keys blocks by their clip, so only requests of the
  same clip hit), and a pool small enough to preempt;
* arena, float and ``serve_quant`` (the ITA integer decode attention);
  the port's ``slot`` equal to its arena;
* every block back with the allocator at drain;
* a copy-on-write of a shared tail block copies K/V (and their scales)
  and leaves the per-slot cross K/V alone.

Speculative decoding and chunked prefill are in
``test_torch_encdec_spec.py``.
"""

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_serve import setup_pair, sync_reference_decode

torch.set_num_threads(1)

NAME = "whisper-small"
BLK = 4
ENGINE_KW = dict(slots=2, max_len=48, block_len=BLK, admit_window=2)


def workload(cfg, n=6, clips=2, seed=3):
    """(decoder prompt, frame embeddings) pairs: a shared 2-block decoder
    prefix plus 2–11 tokens each; request i hears clip i % clips."""
    rng = np.random.default_rng(seed)
    emb_rng = np.random.default_rng(5)
    audio = [(0.1 * emb_rng.standard_normal((cfg.enc_seq, cfg.d_model))
              ).astype(np.float32) for _ in range(clips)]
    shared = rng.integers(0, cfg.vocab, 2 * BLK)
    return [(np.concatenate([shared, rng.integers(
        0, cfg.vocab, int(rng.integers(2, 12)))]).astype(np.int32),
        audio[i % clips]) for i in range(n)]


def identity_cell(quant, max_new=8, n=6, **engine_kw):
    """The same workload through the JAX engine and the port (``backend``
    in ``engine_kw``, default paged); asserts equal greedy streams and
    returns (JAX engine, port engine, port requests)."""
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant)
    kw = dict(ENGINE_KW, **engine_kw)
    kw.setdefault("backend", "paged")
    jkw = dict(kw)
    if kw["backend"] == "paged":
        jkw["attn_backend"] = "interpret" if quant else "xla"
    je = JEngine(jarch, jparams, JEngineConfig(**jkw))
    if kw["backend"] != "slot":   # the JAX slot backend has no cache
        sync_reference_decode(je)
    te = LLMEngine(tarch, tparams, EngineConfig(**kw), device="cpu")
    reqs = workload(tarch.cfg, n=n)
    jh = [je.add_request(p, max_new_tokens=max_new, embeds=e)
          for p, e in reqs]
    th = [te.add_request(p, max_new_tokens=max_new, embeds=e)
          for p, e in reqs]
    je.run_until_drained()
    te.run_until_drained()
    jout = [je.request(h).output for h in jh]
    tout = [te.request(h).output for h in th]
    assert tout == jout
    assert all(len(o) == max_new for o in tout)
    assert ([te.request(h).preemptions for h in th]
            == [je.request(h).preemptions for h in jh])
    return je, te, [te.request(h) for h in th]


def assert_drained(te):
    """Every block back: free, or (prefix cache) cached and reusable."""
    al = te.alloc
    assert al.live_blocks == 0 and al.reserved_unallocated == 0
    assert al.free_blocks + al.cached_blocks == te.layout.usable_blocks


@pytest.mark.parametrize("prefix", [False, True], ids=["cache-off",
                                                      "cache-on"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_identity_with_reference(quant, prefix):
    je, te, _ = identity_cell(quant, prefix_cache=prefix)
    assert te.backend.pool_bytes == je.backend.pool_bytes
    m, jm = te.metrics(), je.metrics()
    assert m["iterations"] == jm["iterations"]
    if prefix:
        # requests of the same clip hit its two shared blocks; the other
        # clip's never do
        assert te.alloc.hit_blocks == je.alloc.hit_blocks >= 2 * 4
        assert m["prefill_skip_rate"] == jm["prefill_skip_rate"] > 0
    else:
        assert te.alloc.hit_blocks == 0
    assert_drained(te)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_preemption_identity_with_reference(quant):
    """Three slots on 13 usable blocks: admissions preempt running
    requests, whose re-prefill reruns the encoder on their clip."""
    _, te, reqs = identity_cell(quant, slots=3, num_blocks=14, n=6,
                                max_new=10)
    assert sum(r.preemptions for r in reqs) >= 1
    assert_drained(te)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8kv"])
def test_arena_identity_with_reference(quant):
    _, te, _ = identity_cell(quant, backend="arena")
    assert te.backend.name == "arena" and te.qparams is None


def test_slot_equals_arena():
    _, _, tarch, tparams = setup_pair(NAME, True)
    reqs = workload(tarch.cfg, n=4)
    outs = {}
    for backend in ("slot", "arena"):
        eng = LLMEngine(tarch, tparams, EngineConfig(backend=backend,
                                                     **ENGINE_KW),
                        device="cpu")
        hs = [eng.add_request(p, max_new_tokens=8, embeds=e)
              for p, e in reqs]
        eng.run_until_drained()
        outs[backend] = [eng.request(h).output for h in hs]
    assert outs["slot"] == outs["arena"]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_copy_on_write_leaves_cross_kv_alone(quant):
    """Fork a running slot's tail block (an extra reference, as a sharer
    would hold): the next iteration copies its K/V (and scales) into a
    private block before writing, the fork keeps its contents, the
    per-slot cross K/V are untouched, ``pool_bytes`` counts only the
    pools, and the stream is the unforked one."""
    _, _, tarch, tparams = setup_pair(NAME, quant)
    prompt, emb = workload(tarch.cfg, n=1)[0]
    prompt = np.concatenate([prompt, prompt])[:13]

    def run(fork):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend="paged", **ENGINE_KW, prefix_cache=True), device="cpu")
        h = eng.add_request(prompt, max_new_tokens=8, embeds=emb)
        eng.step()                                # admission
        eng.step()                                # one decode
        c = eng.cache
        cross = sum(c[k].numel() * c[k].element_size()
                    for k in ("xk", "xv", "len"))
        total = sum(v.numel() * v.element_size() for v in c.values())
        assert eng.backend.pool_bytes == total - cross
        if fork:
            b = eng.backend
            n = b._slot_len[0]
            old = int(b.table[0, n // BLK])
            eng.alloc.incref(old)
            before = {k: c[k][:, old].clone()
                      for k in ("k", "v", "kscale", "vscale") if k in c}
            xk, xv = c["xk"].clone(), c["xv"].clone()
            eng.step()
            new = int(b.table[0, n // BLK])
            assert new != old and eng.alloc.cow_copies == 1
            off = n % BLK
            for k, v in before.items():
                assert torch.equal(c[k][:, old], v), k     # the fork intact
                if k.endswith("scale"):
                    assert torch.equal(c[k][:, new], v), k
                else:
                    assert torch.equal(c[k][:, new, :, :off],
                                       v[:, :, :off]), k
            assert torch.equal(c["xk"], xk) and torch.equal(c["xv"], xv)
            eng.alloc.decref(old)
        eng.run_until_drained()
        assert_drained(eng)
        return eng.request(h).output

    assert run(True) == run(False)
