"""PyTorch port vs JAX reference: the paged engine on ring-block pools for
sliding-window layers.

``gemma3-4b-smoke`` (pattern ``LLLLLG``, window 16) at ``block_len`` 4 and
``max_len`` 64, ``dtype="float32"`` (ring 5 blocks wide). The port's greedy
streams, preemptions, block and ring tables, ``ring_start`` and every
metric not read off the host clock equal the synchronised JAX engine's
after every iteration (float pools on ``attn_backend="xla"``, int8 pools on
``"interpret"``, the kernel contract), under ``bounded`` with a pool small
enough to force preemption and ring re-admission, and under ``fcfs`` with
``prefix_cache``, ``prefill_chunk_tokens`` and ``spec_tokens`` set (the
three opt-outs, all off on a ring layout as in the reference). The ring
allocator is full again after the run; ``pool_bytes`` equals the
reference's; a window at ``max_len`` builds no ring. The cache helpers and
the model-level steps are in ``test_torch_ring.py``.
"""

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch.models import cache as tcache
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_chunked import shared_metrics_equal
from test_torch_ring import BLK, MAX_LEN, NAME, SLOTS, WB
from test_torch_serve import setup_pair, sync_reference_decode

torch.set_num_threads(1)


MAX_NEW = 8


def ring_prompts(vocab, seed=1):
    """Shorter than the 16-token window, straddling it (prompts of 12 and
    14 whose decode crosses it), and longer than the ring (20 tokens),
    whose prefill wraps it; the long prompts' decodes rotate their rings.
    The lengths share three admission buckets (8, 16 and 32 tokens), which
    bounds the reference's traces."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 14, 30, 12, 28, 25, 23, 3)]


def backend_state(b):
    return (b.ring_table.copy(), b.ring_start.copy(), list(b._slot_len))


OPT_OUTS = dict(prefix_cache=True, prefill_chunk_tokens=8, spec_tokens=2)


@pytest.mark.parametrize("quant,scheduler,extra", [
    # a pool of 23 usable blocks: admissions wait and preempt, and
    # preempted requests take a ring again at re-admission
    (False, "bounded", dict(num_blocks=24)),
    (True, "bounded", dict(num_blocks=24)),
    # the three opt-outs, which a ring layout turns off
    (False, "fcfs", OPT_OUTS),
    (True, "fcfs", OPT_OUTS),
], ids=["float-bounded-preempt", "int8-bounded-preempt",
        "float-fcfs-opt-outs", "int8-fcfs-opt-outs"])
def test_ring_engine_matches_reference_every_iteration(quant, scheduler,
                                                       extra):
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, admit_window=2, block_len=BLK,
              scheduler=scheduler, **extra)
    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **kw)))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **kw),
                   device="cpu")
    jb, tb = je.backend, te.backend
    assert tb.ring and jb.ring
    assert tb.layout.ring_blocks == jb.layout.ring_blocks == WB
    assert tb.layout.ring_num_blocks == jb.layout.ring_num_blocks
    # the three opt-outs are the reference's: all off on a ring layout
    for flag in ("prefix_caching", "chunking", "spec_supported"):
        assert getattr(tb, flag) is getattr(jb, flag) is False, flag
    assert te._chunked == je._chunked and te._spec == je._spec == 0
    assert tb.pool_bytes == jb.pool_bytes
    prompts = ring_prompts(tarch.cfg.vocab)
    jh = [je.add_request(p, max_new_tokens=MAX_NEW) for p in prompts]
    th = [te.add_request(p, max_new_tokens=MAX_NEW) for p in prompts]
    while not (te.idle and je.idle):
        je.step()
        te.step()
        jr, tr = backend_state(jb), backend_state(tb)
        for name, j, t in zip(("ring_table", "ring_start", "slot_len"),
                              jr, tr):
            np.testing.assert_array_equal(t, j, err_msg=f"{name} at "
                                          f"iteration {te.iterations}")
        np.testing.assert_array_equal(tb.table, np.asarray(jb.table))
        shared_metrics_equal(te.metrics(), je.metrics())
    assert [te.request(h).output for h in th] == \
        [je.request(h).output for h in jh]
    assert [te.request(h).preemptions for h in th] == \
        [je.request(h).preemptions for h in jh]
    assert all(len(te.request(h).output) == MAX_NEW for h in th)
    if scheduler == "bounded":
        assert sum(te.request(h).preemptions for h in th) >= 1
    m = te.metrics()
    assert m["prefill_chunks_dispatched"] == 0 and m["spec_drafted"] == 0
    assert "prefix_cache_hit_rate" not in m
    assert tb.alloc.hit_blocks == 0 and tb.prefill_tokens_skipped == 0
    # every block of both arenas came back
    assert tb.alloc.free_blocks == tb.layout.usable_blocks
    assert tb.ring_alloc.free_blocks == tb.layout.ring_num_blocks - 1
    assert not tb.ring_table.any() and not tb.ring_start.any()


def test_window_at_max_len_builds_no_ring():
    """``local_window >= max_len``: every layer keeps full history, as in
    the reference (no ring arena, the plain table)."""
    jarch, jparams, tarch, tparams = setup_pair(NAME, False)
    kw = dict(slots=2, max_len=16, block_len=BLK)
    je = JEngine(jarch, jparams, JEngineConfig(backend="paged", **kw))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **kw),
                   device="cpu")
    assert not te.backend.ring and not je.backend.ring
    assert te.layout.window is None and te.layout.ring_num_blocks == 0
    assert te.backend.pool_bytes == je.backend.pool_bytes
    assert isinstance(te.backend._tables(), torch.Tensor)
    assert te.backend.spec_supported and te.backend.chunking is False
    h = te.add_request(np.arange(5, dtype=np.int32), max_new_tokens=4)
    te.run_until_drained()
    assert len(te.request(h).output) == 4


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_ring_pool_bytes_bounded_by_the_window(quant):
    """The ring arena is what bounds residency: at max_len 64 a ring layout
    holds fewer pool bytes than the full-history layout of the same pools
    would, by the reference's own count."""
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, block_len=BLK)
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **kw),
                   device="cpu")
    je = JEngine(jarch, jparams, JEngineConfig(backend="paged", **kw))
    assert te.backend.pool_bytes == je.backend.pool_bytes
    full = tarch.init_paged_cache(SLOTS, tcache.PagedLayout(
        BLK, te.layout.num_blocks, MAX_LEN), device="cpu")
    full_bytes = sum(t.numel() * t.element_size() for c in full["stacks"]
                     for t in c.values())
    assert te.backend.pool_bytes < full_bytes
    cfg = tarch.cfg
    groups = cfg.layer_layout()[1]
    n_l = cfg.pattern.count("L") * groups
    per_row = full_bytes // (groups * len(cfg.pattern)
                             * te.layout.num_blocks)
    assert full_bytes - te.backend.pool_bytes == n_l * per_row * (
        te.layout.num_blocks - te.layout.ring_num_blocks)
