"""PyTorch port vs JAX reference: the serving surfaces beside the token path.

Port and (synchronised) JAX engine on ``glm4-9b-smoke``, float and int8
pools (int8 anchored on ``attn_backend="interpret"``), driven by the same
script of arrivals. Equal between the two, request by request: greedy
streams, ``finish_reason``s and preemption counts; iteration by iteration:
which request holds each slot, in which state, at which prefill cursor; and
every shared metric that does not read the host clock.

* ``scheduler="qos"``: ``rt`` arrivals mid-run preempting ``be`` within
  ``rt_window``; the ``be_grant_window`` wide beat; ``be_token_share``
  shaping (the reference's ``tests/test_schedulers.py`` cases on real
  engines);
* ``eos_token``, one- and multi-token ``stop_sequences``, a stop on the
  admission's first token, and ``stream()`` (the reference's
  ``tests/test_serve_api.py`` cases);
* ``qos`` under chunked prefill: ``chunk_order`` drains the shared budget
  into ``rt`` chunks before ``be`` ones.
"""

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch.serve import EngineConfig, LLMEngine, RequestState

from test_torch_serve import setup_pair, sync_reference_decode

torch.set_num_threads(1)

BLK = 8
QUANTS = pytest.mark.parametrize("quant", [False, True],
                                 ids=["float", "int8"])


def engine_pair(quant, **kw):
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", quant)
    ec = dict(max_len=64, block_len=BLK, **kw)
    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **ec)))
    return je, LLMEngine(tarch, tparams, EngineConfig(backend="paged", **ec),
                         device="cpu")


def prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def drive(eng, script, max_iters=300):
    """Run ``script`` ({iteration: [add_request kwargs]}) to the end;
    returns the requests and, for each iteration, each slot's (rid, state,
    prefill cursor)."""
    handles, trace = [], []
    last = max(script)
    for it in range(max_iters):
        for kw in script.get(it, []):
            handles.append(eng.add_request(**kw))
        if eng.idle and it >= last:
            break
        eng.step()
        trace.append(tuple(None if r is None else
                           (r.rid, r.state, r.prefill_pos)
                           for r in eng.slots))
    assert eng.idle
    return [eng.request(h) for h in handles], trace


def assert_same_run(je, te, script):
    jreqs, jtrace = drive(je, script)
    treqs, ttrace = drive(te, script)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert ttrace == jtrace
    m, jm = te.metrics(), je.metrics()
    assert set(m) == set(jm)
    for key in m:
        if "wall" not in key and "jitter" not in key:
            assert m[key] == jm[key], key
    assert te.alloc.live_blocks == 0
    return treqs, ttrace


def admission_order(trace):
    order = []
    for slots in trace:
        for s in slots:
            if s is not None and s[0] not in order:
                order.append(s[0])
    return order


def grant_script():
    """A be request holds the only slot, eight short rt requests queue, then
    a second be request (rid 501)."""
    script = {0: [dict(prompt=prompt(9, 500), max_new_tokens=4, qos="be",
                       rid=500)]}
    script[1] = [dict(prompt=prompt(6 + k % 5, k), max_new_tokens=2,
                      qos="rt", rid=k) for k in range(8)]
    script[1].append(dict(prompt=prompt(7, 501), max_new_tokens=2, qos="be",
                          rid=501))
    return script


@QUANTS
def test_qos_rt_arrivals_mid_run_match_reference(quant):
    """Three long be requests fill two slots; rt requests arrive at
    iterations 3 and 6 and are forced in within ``rt_window``, preempting
    be slots."""
    je, te = engine_pair(quant, slots=2, scheduler="qos", rt_window=2)
    script = {0: [dict(prompt=prompt(9 + i, i), max_new_tokens=14, qos="be",
                       rid=100 + i) for i in range(3)],
              3: [dict(prompt=prompt(7, 7), max_new_tokens=4, qos="rt",
                       rid=1)],
              6: [dict(prompt=prompt(12, 8), max_new_tokens=3, qos="rt",
                       rid=2)]}
    treqs, trace = assert_same_run(je, te, script)
    assert sum(r.preemptions for r in treqs) >= 1
    assert all(r.preemptions == 0 for r in treqs if r.qos == "rt")
    # each rt request held a slot within rt_window + 1 iterations
    for rid, at in ((1, 3), (2, 6)):
        first = next(i for i, slots in enumerate(trace)
                     if any(s is not None and s[0] == rid for s in slots))
        assert first - at <= te.ec.rt_window


@QUANTS
@pytest.mark.parametrize("share", [None, 0.3], ids=["be-grant-window",
                                                    "be-token-share"])
def test_qos_be_grant_window_and_token_share_match_reference(quant, share):
    """``be_grant_window=2``: after two rt grants with be waiting, the next
    grant goes to be. With ``be_token_share=0.3`` the running be-token
    fraction holds that grant back while rt demand waits."""
    je, te = engine_pair(quant, slots=1, scheduler="qos", rt_window=64,
                         be_grant_window=2, be_token_share=share)
    _, trace = assert_same_run(je, te, grant_script())
    rt_before_be2 = admission_order(trace).index(501) - 1
    if share is None:
        assert rt_before_be2 <= te.ec.be_grant_window
    else:
        assert rt_before_be2 > te.ec.be_grant_window


@QUANTS
def test_eos_stop_sequences_and_stream_match_reference(quant):
    """On one engine pair: a plain run gives the greedy tokens; then
    requests of the same prompt end on ``eos_token`` (mid-stream, on the
    last token, and on the admission's first token, which releases its
    blocks at once) and on one- and multi-token ``stop_sequences``; then
    ``stream()`` over two interleaved requests yields what the reference's
    does."""
    je, te = engine_pair(quant, slots=4)
    p = prompt(10, 3)
    plain, _ = assert_same_run(je, te, {0: [dict(prompt=p, max_new_tokens=8,
                                                 rid=0)]})
    toks = plain[0].output
    assert len(toks) == 8
    vocab = te.arch.cfg.vocab
    conds = [dict(eos_token=toks[2]),
             dict(eos_token=toks[7]),
             dict(stop_sequences=[toks[3:5], [vocab + 5]]),
             dict(stop_sequences=[[toks[1]]])]
    treqs, _ = assert_same_run(je, te, {0: [
        dict(prompt=p, max_new_tokens=8, rid=10 + i, **c)
        for i, c in enumerate(conds)]})
    assert [r.finish_reason for r in treqs] == ["eos", "eos", "stop", "stop"]
    assert treqs[0].output == toks[:toks.index(toks[2]) + 1]
    assert treqs[2].output == toks[:5]
    assert treqs[3].output == toks[:toks.index(toks[1]) + 1]

    first, _ = assert_same_run(je, te, {0: [dict(
        prompt=p, max_new_tokens=4, rid=20, eos_token=toks[0])]})
    assert first[0].output == [toks[0]] and first[0].finish_reason == "eos"
    assert te.alloc.free_blocks == te.layout.usable_blocks

    seen = []
    for eng in (je, te):
        h0 = eng.add_request(prompt(8, 4), max_new_tokens=5, rid=30)
        h1 = eng.add_request(prompt(11, 5), max_new_tokens=3, rid=31)
        got = [(o.rid, o.token, o.finish_reason, o.state)
               for h in (h0, h1) for o in eng.stream(h)]
        assert eng.idle
        seen.append(got)
    assert seen[1] == seen[0]
    assert [t for rid, t, _, _ in seen[1] if rid == 30] == \
        te.request(30).output
    assert seen[1][-1][2] == "length"


@QUANTS
def test_qos_chunked_prefill_drains_rt_chunks_first(quant):
    """A long be prompt is mid-chunk when a long rt prompt arrives, under a
    one-block budget: from then on the rt cursor takes the budget every
    iteration and the be cursor waits until rt's prefill is done."""
    je, te = engine_pair(quant, slots=3, scheduler="qos",
                         prefill_chunk_tokens=BLK)
    script = {0: [dict(prompt=prompt(41, 0), max_new_tokens=4, qos="be",
                       rid=100)],
              2: [dict(prompt=prompt(33, 1), max_new_tokens=3, qos="rt",
                       rid=1)]}
    _, trace = assert_same_run(je, te, script)
    cursors = [{s[0]: s[2] for s in slots
                if s is not None and s[1] == RequestState.PREFILL}
               for slots in trace]
    both = [i for i, c in enumerate(cursors) if len(c) == 2]
    assert both, cursors
    for i in both[1:]:
        assert cursors[i][1] > cursors[i - 1][1]      # rt advances
        assert cursors[i][100] == cursors[i - 1][100]  # be waits
    assert te.metrics()["prefill_chunk_stalls"] > 0
