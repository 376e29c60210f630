"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints a start line with the seconds elapsed, and exits
non-zero on failure; none is caught):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   all started together; the ITA fused attention's, the longest build,
   finishes while phases 2-5 run, and its kernel is checked at the start
   of phase 6);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes glm4-9b's serving path gives it (and gemma3-4b's, below) — the
   int8 GEMM bit-exact on K-major weights (every projection at M = 1,
   decode's 8, verify's 40, and the 64-row tile edge 64 and 65; ragged
   shapes and int32-range biases), with its per-projection times, grids and device time a layer
   and ``torch._int_mm`` alone as a second yardstick, paged decode and
   verify attention
   allclose (also with lens on and beside their split boundaries, a window
   starting inside a split and a 4096-key row), verify at Q = 1 and in
   row 0 bit-equal to decode; paged decode attention at gemma3-4b's
   geometry (8 query and 4 kv heads of 256, block_len 16, window 1024) on
   f32, bf16 and int8 pools, over ring tables 65 entries wide with
   ``start`` = first·16 for first in {0, 1, 62, 185} and lens − start from
   1 to 1040, and over a G layer's full-history table with rows up to 4096
   keys (whole splits below the window), each allclose and then timed, and
   the int8 GEMM bit-exact on gemma3-4b's seven projections at M = 1 and 8;
   one glm4-9b layer's seven projections at M = 1 (the slot backend's int8
   decode) timed beside its bound and ``torch._int_mm`` at M = 32; the int8
   arena's ``decode_attention_int8`` (plain PyTorch, float64 products) on
   the card equal to the CPU's bit for bit at glm4-9b's decode (8 rows, a
   1024-row cache, lens 1–1024, a row of equal logits; bf16 and f32) and at
   gemma3-4b's ring layers (rows wrapped past the 1024-row ring), timed;
   paged decode and verify attention at qwen3-moe-30b-a3b's geometry (32
   query heads on 4 kv heads of 128, a GQA group of 8; 8 rows up to 4096
   keys) on f32, bf16 and int8 pools, allclose, then timed beside SDPA
   — and the SSD chunked scan
   at mamba2-2.7b's widths (S = 1, 5, 129, 512, 2048, and a G = 2 case of
   40 heads a group) allclose, y bit-equal with and without the state, with
   its device time, CUDA launches and grids a call, and the RG-LRU scan at
   recurrentgemma-9b's width (D = 4096; S = 1 to 2300, 63 / 64 / 65 and
   192 / 193 at its 64-row tile and ring, and B = 3 at 300 and 2300, bf16
   and f32 inputs) allclose, with its event and device time per S, (at
   the start of phase 6) the ITA fused attention at each width phase 6
   runs (glm4-9b's prefill, DINOv2-S, Whisper-Tiny encoder, MobileBERT;
   event and device time each)
   and at a GQA-free case, 64-, 125- and 137-key tiles (causal), a GQA
   group of 16 at S = 1000 and the saturated causal corner (64- and
   60-key tiles) bit-exact, and the ITA integer softmax at each
   paper network's per-layer logits (event and device time, bounds and
   launch plan each) and at ragged rows and columns, rows at and beside
   its staged body's limit, a row of 2^22, extreme logits and a view off
   the 16-byte grid, bit-exact; time kernel, plain version, a library
   yardstick where one PyTorch call computes the same function (timed here,
   never called by the port) and the card's bound; for the paged-attention
   kernels and their yardsticks also the device time a call as
   ``torch.profiler`` sees it, and the kernels' grids;
3. serve full-width glm4-9b (random weights from a seeded generator, depth
   as published) through ``LLMEngine(backend="paged")`` with bf16 pools and
   with int8 pools: plain decode, then speculative decoding
   (``spec_tokens=4``) with the prefix cache on a shared-prefix workload
   (and the same workload with ``spec_tokens=0`` beside it), with every
   launch count set to 0 just before and read just after each run; check
   every request finishes with its token count, the logits are finite, the
   kernels' results agree with the CPU's plain versions on a small input,
   and spec on gives spec off's greedy tokens on a small input; chunked
   prefill (``prefill_chunk_tokens``): on a small input, chunks of one and
   two blocks with the prefix cache off and on give the CPU's chunked
   tokens (and, on float pools, the monolithic run's), and at full width
   a long-prompt workload (14 prompts of 64–512 tokens, 2 of 3000–4000,
   ``max_len`` 4128) chunked by 512 on int8 and bf16 pools and monolithic
   on int8 pools, and the shared-prefix workload chunked by 128 with the
   prefix cache on int8 pools, each with its iteration walls (p50, p99,
   max), jitter, time to first token and chunks dispatched; then time
   steady-state decode steps on both pool types (host clock, and device
   time a step with the int8 GEMM's share from ``torch.profiler``); then
   the float-cache arena (``serve_quant=False``, plain PyTorch, no
   hand-written kernel): on small inputs (glm4-9b-smoke, gemma3-4b-smoke
   with its 16-row rings, float32) the arena's greedy tokens on the card
   against the CPU's, the slot backend's equal to the arena's and the
   paged backend's (float32 pools) against the arena's, with no kernel
   launched by the arena and slot runs; at full width 8 requests x 16
   tokens of 64–512-token prompts through ``LLMEngine(backend="arena")``
   with bf16 caches (8 slots, ``max_len`` 1024, length-bucketed
   admission): token counts, finite logits, no kernel launched, the
   admissions by bucket, tokens/s, the iteration p50 and one profiled
   steady decode step beside its bytes bound and the paged bf16 step;
   and 2 requests x 8 tokens through ``slot`` equal to a 2-slot arena's;
   then the int8 arena step (``serve_quant``: W8A8 projections through the
   int8 GEMM, int8 K/V in the bf16 caches, the ITA integer
   ``decode_attention_int8``): on small inputs (glm4-9b-smoke,
   gemma3-4b-smoke, llava-next-34b-smoke on token prompts; float32) the
   arena's greedy tokens on the card against the CPU's, slot == arena on
   the card, the GEMM launched seven times a layer and decode step and
   nothing else; at full width the same 8 x 16 run with bf16 weights and
   int8 ``qparams``: token counts, finite logits, the GEMM launched exactly
   280 times a decode step (prefill none) and every other counter at 0,
   the admissions by bucket, tokens/s, the iteration p50 and one profiled
   steady decode step with the GEMM's share beside its bytes bound (int8
   projection weights, the bf16 unembedding, 8 embedding rows, the valid
   K/V); then 2 x 8 tokens through ``slot`` (the GEMM at M = 1) equal to a
   2-slot arena's;
4. serve full-width mamba2-2.7b (random bf16 weights, 64 layers) through
   ``LLMEngine(backend="arena")``, its launch counts set to 0 just before
   and read just after; check every request finishes with its token count,
   one more decode step's logits are finite, and on a small input the card
   agrees with the CPU and the slot backend with the arena; then one
   512-token admission prefill's device time, split into B8 and the rest;
5. serve full-width recurrentgemma-9b (random bf16 weights, 38 layers: 26
   recurrent, 12 local attention) through ``LLMEngine(backend="arena")``
   with two prompts longer than the 2048-token window, so the ring caches
   wrap; the same checks as phase 4 (small input: recurrentgemma-9b-smoke,
   window 16), and B9 launched once per recurrent layer and admission
   prefill; then one 512-token admission prefill's device time, split into
   B9 and the rest, its logits and cache bit-equal to an unprofiled
   prefill's;
6. the ITA integer path at full width: ``int8_attention`` once per
   attention layer of MobileBERT, the Whisper-Tiny encoder, DINOv2-S and a
   2048-token glm4-9b prompt (bf16 inputs), and ``int_softmax`` once per
   layer on the three paper networks' [H·S, S] int8 logits, the launch
   counts set to 0 just before and read just after each network: B6
   launched once per attention layer, B7 once per paper-network layer,
   every output finite, and on a small input the card's ``int8_attention``
   and ``int_softmax`` equal the CPU's plain path bit for bit; then each
   network's attention pass again under ``torch.profiler``: its device
   time and B6's share, its outputs bit-equal to the first pass's;
7. serve full-width gemma3-4b (random bf16 weights, 34 layers: 29
   sliding-window layers on ring pools of 65 blocks a slot, 5 global ones
   on the full-history pool; ``max_len`` 4128) through
   ``LLMEngine(backend="paged")``: 16 requests × 32 tokens (12 prompts of
   64–512 tokens, 2 of 1000–1020 whose decodes cross the window and the
   first ring rotation, 2 of 3000–4000 whose rings wrap inside the
   prefill) on int8 and bf16 pools, and on int8 pools again with
   ``prefix_cache``, ``prefill_chunk_tokens`` and ``spec_tokens`` set,
   which a ring layout turns off; check every request finishes with its
   token count and finite logits, each decode step launches the attention
   kernel once a layer and (int8) the GEMM seven times a layer, the
   opt-out run launches no verify kernel, dispatches no chunk, hits no
   prefix and gives the plain int8 run's tokens, ``pool_bytes`` is the
   ring layout's (printed beside the full-history layout's), and on a
   small input (gemma3-4b-smoke, window 16) the card agrees with the CPU;
   print each run's iteration walls and time to first token, and one
   steady-state int8 decode step's device time with the GEMM's and the
   attention kernel's shares;
8. serve full-width qwen3-moe-30b-a3b (random bf16 weights, 48 layers of
   128 experts, top 8, float weights) through ``LLMEngine(backend=
   "paged")``: 16 requests x 32 tokens of 64–512-token prompts on int8 and
   bf16 pools, the shared-prefix workload on int8 pools with the prefix
   cache and ``spec_tokens`` 0 and 4, and long prompts (2 of 3000–4000
   tokens) chunked by 512 on int8 pools; check every request finishes
   with its token count and finite logits, each decode step launches B2
   (B1 on bf16 pools) once a layer, each verify step B5 once a layer, and
   nothing else (no int8 GEMM: the family keeps float weights), and on a
   small input (qwen3-moe-30b-a3b-smoke, float32, capacity 1.25) the card
   gives the CPU's greedy tokens on both pool types and spec on gives
   spec off's; print one steady-state int8 decode step's device time with
   the attention kernel's share and the device's busy share, beside the
   step's bytes bound (every weight read once); then the float-cache
   arena: on a small input (float32) the checks of phase 3's, and at full
   width 4 requests x 8 tokens of exact 64–512-token prompts through
   ``LLMEngine(backend="arena")`` with bf16 caches (``max_len`` 1024), with
   phase 3's checks and readings; then the int8 arena step the same way
   (small input: qwen3-moe-30b-a3b-smoke under ``serve_quant``; full width:
   8 requests x 16 tokens, float weights, int8 K/V, no hand-written kernel
   launched);
9. serve full-width whisper-small (random bf16 weights: 12 encoder and 12
   decoder layers, 12 heads of 64, 1500 frames, ``max_len`` 448), every
   request carrying its own frame embeddings (``embeds``), through
   ``LLMEngine(backend="paged")`` on int8 and bf16 pools: 16 requests x
   32 tokens of 4–64-token decoder prompts, spec 4 with the prefix cache
   on 4 clips of 4 requests sharing a 32-token decoder prefix, and 8 x 16
   of the plain workload chunked by 16; check every request finishes with its
   token count and finite logits, each decode step launches B2 (B1) and
   each verify step B5 (B4) exactly once a layer and nothing else, and
   the spec run hits the prefix cache; time steady 8-slot decode steps
   and profile one decode and one verify step, each bit-equal to an
   unprofiled one with the attention kernel listed once a layer; then the
   arena with bf16 caches, float and ``serve_quant``, 8 x 16 with no
   kernel launched, and ``slot`` == arena on 2 x 8 tokens; before it, on
   small inputs (whisper-small-smoke: paged float32 and int8 pools, arena
   float and int8, slot; llava-next-34b-smoke with embeds requests on the
   arena) the card's greedy tokens against the CPU's. Phase 2 holds B1,
   B2, B4 and B5 at whisper-small's geometry (12 query heads on 12 kv
   heads of 64, a GQA group of 1; 8 rows of lens 0–448).

Every ``torch.profiler`` session keeps host-idle margins inside both ends
(``profiled``): in a few sessions in a hundred the profiler places the
device records milliseconds early on the host clock, and without the
margin the first kernels' records fall outside the session and are lost
(``profiler_loss.py`` counts it). Once the process has served a model, the
profiler also drops the records of each session's first 9 to 16 launches,
so every session opens with a prologue of empty spin kernels that takes
that loss and is left out of every reading.

The last lines of stdout are a ``{"kernels": [...]}`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12,
            # scalar int32 on the CUDA cores: the f32 rate counts an FMA as
            # two on 128 lanes per SM; an SM has 64 INT32 lanes, one each
            "int32": 67e12 / 4}
SEED = 0


T_START = time.perf_counter()


def phase(n: int, what: str) -> None:
    """A phase's start line: if a run fails, the last lines of stdout name
    the phase it failed in."""
    print(f"phase {n} ({what}) starts at "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, kind: str, **other_ops: float):
    """Least ms for the work: bytes at the memory rate, or the operations of
    the slowest unit (``other_ops``: kind=count run alongside ``kind``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS[k] for k, n in
                {kind: ops, **other_ops}.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(torch, fn, reps: int, flush=None) -> float:
    """Mean ms per call from CUDA events around each call; ``flush`` (run
    outside the timed window) evicts L2 when the real caller finds it cold."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


# torch.profiler puts a session's device records on the host clock. In a few
# sessions in a hundred that placement is early by milliseconds, and the
# records of the first kernels, now before the session's start, are dropped:
# the kernels ran (their outputs are bit-equal to an unprofiled pass's and
# the launch counters are right), but the profiler does not list them.
# Host-idle time inside both ends of the session keeps every record in it.
PROFILE_MARGIN_S = 0.05
# Besides, once a process has served a model, every session loses the device
# records of its first launches (9 to 16 of them, more as the process goes
# on; their host-side launch records are all there). A prologue of empty
# spin kernels opens each session and takes that loss; its records are left
# out of what the session lists.
PROLOGUE_LAUNCHES = 256
PROLOGUE_KERNEL = "spin_kernel"


class Profile:
    """A finished ``torch.profiler`` session without its prologue."""

    def __init__(self, prof):
        self.prof = prof

    def key_averages(self):
        return [e for e in self.prof.key_averages()
                if PROLOGUE_KERNEL not in e.key]

    def events(self):
        return [e for e in self.prof.events()
                if PROLOGUE_KERNEL not in e.name]


@contextlib.contextmanager
def profiled(torch):
    """A ``torch.profiler`` session over CPU and CUDA activity that opens
    with ``PROLOGUE_LAUNCHES`` empty spin kernels (``torch.cuda._sleep``)
    and keeps ``PROFILE_MARGIN_S`` of host-idle time inside each end; the
    body's work is synchronised before the closing margin. Yields a
    ``Profile``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROLOGUE_LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        yield Profile(prof)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)


def bit_equal(got, want) -> bool:
    """Tensors (in dicts, lists and tuples) equal bit for bit."""
    import torch

    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            bit_equal(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            bit_equal(a, b) for a, b in zip(got, want))
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8)))


def dev_us(e) -> float:
    """An event's own device time (µs) in ``torch.profiler``'s averages."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, flush, reps: int = 20, by_op=None):
    """Device time per call from ``torch.profiler``: what ``fn`` puts on
    the card (kernels, memsets), with L2 flushed before each call as in
    ``timed``; the flush's own kernels are left out. Returns (ms or None
    when the profiler saw no device activity, device ops per call), and
    fills ``by_op`` (a dict, when given) with ms per call by op name."""
    def on_device(prof):
        return {e.key: (dev_us(e), e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    with profiled(torch) as prof:
        flush()
    skip = set(on_device(prof))
    fn()
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        for _ in range(reps):
            flush()
            fn()
    seen = {k: v for k, v in on_device(prof).items() if k not in skip}
    if by_op is not None:
        by_op.update({k: t / reps / 1e3 for k, (t, _) in seen.items()})
    total = sum(t for t, _ in seen.values())
    return (total / reps / 1e3 if total else None,
            sum(c for _, c in seen.values()) / reps)


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions at glm4-9b's serving shapes
# ---------------------------------------------------------------------------


def split_lens(cfg, blk, pool, top):
    """Lens on, one below and one past the paged-attention kernels' split
    boundaries for a table sized for ``top`` keys (as ``attention_case``
    sizes it): ``top`` = 544 (phase 2's table) or 4096 (a longer split)."""
    import torch

    from repro_torch.kernels.paged_attention import ops

    m = -(-(top + 2 * blk) // blk)
    esz = torch.empty((), dtype=pool).element_size()
    w = ops.split_plan(m, blk, cfg.hd, esz)[1] * blk     # keys per split
    if top > 2048:
        return [0, 1, w - 1, w, w + 1, 1000, 2047, top]
    return [0, w - 1, w, w + 1, 2 * w - 1, 2 * w, 2 * w + 1, top]


def check_int8_gemm(torch, cfg, slots, verify_rows, flush):
    from repro_torch.core import quant
    from repro_torch.kernels.int8_gemm import ops
    from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
              "wg": (d, f), "wu": (d, f), "wd": (f, d)}

    def operands(k, n, bias_range=20000):
        # K-major weights, as quantize_params lays them out on the card
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8).mT
        scale = torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev))
        mult, shift = quant.quantize_to_fixed_point(scale)
        bias = torch.randint(-bias_range, bias_range, (n,), generator=g,
                             device=dev, dtype=torch.int32)
        return w, bias, mult.to(torch.int32), shift.to(torch.int32)

    layer = {name: operands(k, n) for name, (k, n) in shapes.items()}
    tile_edge = 64                       # the kernel's rows per tile
    xs = {m: torch.randint(-127, 128, (m, max(d, f)), generator=g,
                           device=dev, dtype=torch.int8)
          for m in (1, slots, verify_rows, tile_edge, tile_edge + 1)}
    # ragged shapes (K, N off the 16-byte and tile grids: the byte-wise
    # loads, zero-filled rows and columns) and biases over the whole int32
    # range (requantize's large-accumulator branch, acc + bias wrapping)
    extra = [(m, k, n, operands(k, n, r)) for m, k, n, r in (
        (3, 30, 7, 20000), (5, 96, 40, 20000), (65, 640, 200, 20000),
        (slots, 96, 40, 2 ** 31 - 1), (verify_rows, d, 256, 2 ** 31 - 1))]
    cases = [(f"{name} M={m}", xs[m][:, :w[0].shape[0]].contiguous(), w)
             for m in xs for name, w in layer.items()]
    cases += [(f"ragged/bias M={m} K={k} N={n}",
               torch.randint(-127, 128, (m, k), generator=g, device=dev,
                             dtype=torch.int8), w) for m, k, n, w in extra]
    n_checked = 0
    for label, xk, (w, bias, mult, shift) in cases:
        for act in ("none", "relu", "gelu"):
            scales = (4.0 / 127, 4.0 / 127) if act == "gelu" else None
            y = ops.int8_gemm_cuda(xk, w, bias, mult, shift,
                                   activation=act, act_scales=scales)
            ref = int8_gemm_ref(xk, w, bias, mult, shift,
                                activation=act, act_scales=scales)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                bad = (y != ref).sum().item()
                raise AssertionError(
                    f"int8_gemm {label} {act}: {bad} outputs differ")
            n_checked += 1

    def layer_args(m):
        x = xs[m]
        return [(x[:, :w.shape[0]].contiguous(), w, b, mu, sh)
                for w, b, mu, sh in layer.values()]

    # timing unit: one layer's seven W8A8 projections at M = slots, at the
    # verify pass's M = slots · (spec_tokens + 1), and at the slot
    # backend's batch-1 decode, M = 1
    args, args_v = layer_args(slots), layer_args(verify_rows)
    args_1 = layer_args(1)

    def kernel():
        for a in args:
            ops.int8_gemm_cuda(*a)

    def kernel_verify():
        for a in args_v:
            ops.int8_gemm_cuda(*a)

    def kernel_m1():
        for a in args_1:
            ops.int8_gemm_cuda(*a)

    def plain():
        for a in args:
            int8_gemm_ref(*a)

    # cuBLASLt's int8 GEMM (torch._int_mm) wants more than 16 rows and B
    # column-major, which the K-major weights are
    pad = 32
    lib_args = [(torch.cat([a[0], a[0].new_zeros(pad - slots, a[0].shape[1])]),)
                + a[1:] for a in args]
    lib_args_1 = [torch.cat([a[0], a[0].new_zeros(pad - 1, a[0].shape[1])])
                  for a in args_1]

    def library():
        for xp, w, b, mu, sh in lib_args:
            acc = torch._int_mm(xp, w) + b
            quant.requantize(acc, mu, sh)

    def library_mm():
        for xp, w, *_ in lib_args:
            torch._int_mm(xp, w)

    def library_mm_m1():
        for xp, a in zip(lib_args_1, args_1):
            torch._int_mm(xp, a[1])

    def gemm_bound(m, names=shapes):
        ws = [layer[k][0] for k in names]
        nbytes = sum(m * w.shape[0] + w.numel() + 12 * w.shape[1]
                     + m * w.shape[1] for w in ws)
        ops_n = sum(2 * m * w.shape[0] * w.shape[1] for w in ws)
        return bound(nbytes, ops_n, "int8")

    # per projection, with L2 flushed before each call as a step finds it
    # (holding other weights, clean: the flush reads, so no write-back of
    # dirty lines lands on the projection's time); grid = blocks launched
    per_proj = {}
    for m, a_m in ((1, args_1), (slots, args), (verify_rows, args_v)):
        for name, a in zip(layer, a_m):
            per_proj[f"{name} M={m}"] = (
                timed(torch, lambda a=a: ops.int8_gemm_cuda(*a), 20, flush),
                gemm_bound(m, [name])[0], ops.grid(m, *shapes[name]))
    b_ms, b_by = gemm_bound(slots)
    bv_ms, _ = gemm_bound(verify_rows)
    b1_ms, b1_by = gemm_bound(1)
    dev_ms, dev_ops = device_ms(torch, kernel, flush)
    dev_v_ms, _ = device_ms(torch, kernel_verify, flush)
    return dict(
        name="int8_gemm", route="cuda",
        source="src/repro_torch/kernels/int8_gemm/csrc/int8_gemm.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=timed(torch, kernel, 20),
        plain_ms=timed(torch, plain, 5), bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(torch, library, 20),
        library_mm_ms=timed(torch, library_mm, 20),
        shape=f"7 projections of one layer, M={slots} (library: M={pad})",
        cases_checked=n_checked, verify_rows=verify_rows,
        verify_ms=timed(torch, kernel_verify, 20), verify_bound_ms=bv_ms,
        device_ms=dev_ms, device_ops=dev_ops, verify_device_ms=dev_v_ms,
        per_proj=per_proj, m1_ms=timed(torch, kernel_m1, 20, flush),
        m1_device_ms=device_ms(torch, kernel_m1, flush)[0],
        m1_bound_ms=b1_ms, m1_bound_by=b1_by,
        m1_library_mm_ms=timed(torch, library_mm_m1, 20, flush))


def check_int8_decode_attention(torch, cfg, gcfg, slots, flush):
    """The int8 arena's ``decode_attention_int8`` (plain PyTorch, float64
    products on both devices) on the card against the CPU, bit for bit:
    ``cfg``'s decode (glm4-9b: ``slots`` rows, a 1024-row cache, lens
    1–1024, the last row's logits all equal so Σp8 is at its largest) in
    bf16 and float32, and ``gcfg``'s ring layers (gemma3-4b: 8 / 4 heads of
    256 over a 1024-row ring, rows wrapped past it) in bf16; caches holding
    the integers in the compute dtype, as the arena's do. Returns the
    cases checked, the card's ms a call at ``cfg``'s bf16 shape (event ms,
    L2 flushed), the CPU's and the call's bytes bound (q, the valid K/V
    rows, the output)."""
    from repro_torch.models.attention import decode_attention_int8

    g = torch.Generator().manual_seed(SEED + 2)
    s = 1024
    cases = {}
    for c, dtype, lens in (
            (cfg, torch.bfloat16, [1, 17, 130, 255, 512, 777, 1000, 1024]),
            (cfg, torch.float32, [1, 17, 130, 255, 512, 777, 1000, 1024]),
            (gcfg, torch.bfloat16, [1, 300, 1023, 1024, 1025, 1500, 2900,
                                    3000])):
        q = torch.randn((slots, c.n_heads, 1, c.hd), generator=g) * 2
        k = torch.randint(-127, 128, (slots, c.n_kv_heads, s, c.hd),
                          generator=g).float()
        v = torch.randint(-127, 128, (slots, c.n_kv_heads, s, c.hd),
                          generator=g).float()
        k[-1] = 0                        # equal logits: every p8 is 127
        args = [t.to(dtype) for t in (q, k, v)] + [
            torch.tensor(lens[:slots], dtype=torch.int32)]
        want = decode_attention_int8(*args)
        dev_args = [t.cuda() for t in args]
        got = decode_attention_int8(*dev_args)
        torch.cuda.synchronize()
        label = f"{c.name} {str(dtype).split('.')[-1]}"
        if not bit_equal(got.cpu(), want) \
                or not bool(torch.isfinite(want).all()):
            raise AssertionError(f"decode_attention_int8 {label}: card vs "
                                 f"CPU differ or not finite")
        cases[label] = (args, dev_args)
    args, dev_args = cases[f"{cfg.name} bfloat16"]
    esz = 2
    valid = int(torch.clamp(args[3], max=s).sum())
    nbytes = (2 * args[0].numel() + 2 * valid * cfg.n_kv_heads * cfg.hd) * esz
    t0 = time.perf_counter()
    for _ in range(3):
        decode_attention_int8(*args)
    cpu_ms = (time.perf_counter() - t0) / 3 * 1e3
    return dict(cases_checked=len(cases),
                ms=timed(torch, lambda: decode_attention_int8(*dev_args), 20,
                         flush),
                cpu_ms=cpu_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def attention_case(torch, cfg, slots, lens, *, pool_dtype, int8, blk,
                   window=None, start=False, seed=1, qlen=1, width=None,
                   firsts=None):
    """Paged-attention inputs at ``cfg``'s head geometry: a table sized for
    the longest row plus two blocks (or ``width`` entries); ``start`` puts
    row i's entry 0 at (i % 3)·blk, ``firsts`` (cycled over the rows) at
    first·blk, with lens measured from there."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = width or max(-(-(max(lens) + 2 * blk) // blk), 1)
    n = slots * m + 1
    q = torch.randn((slots, hq, qlen, d), generator=g, device=dev) * 2.0
    if int8:
        kp = torch.randint(-127, 128, (n, hkv, blk, d), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n, hkv, blk, d), generator=g,
                           device=dev, dtype=torch.int8)
    else:
        kp = torch.randn((n, hkv, blk, d), generator=g, device=dev)
        vp = torch.randn((n, hkv, blk, d), generator=g, device=dev)
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    q = q.to(torch.bfloat16 if pool_dtype == torch.bfloat16 else torch.float32)
    perm = torch.randperm(n - 1, generator=g, device=dev)[:slots * m] + 1
    table = perm.reshape(slots, m).to(torch.int32)
    st = None
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if start:
        st = (torch.arange(slots, device=dev, dtype=torch.int32) % 3) * blk
        lens_t = torch.where(lens_t > 0, lens_t + st, 0).to(torch.int32)
    if firsts is not None:
        st = torch.tensor([firsts[i % len(firsts)] * blk
                           for i in range(slots)], dtype=torch.int32,
                          device=dev)
        lens_t = lens_t + st
    kw = dict(window=window, start=st)
    if int8:
        kw["k_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
        kw["v_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
    return (q, kp, vp, table, lens_t), kw


def check_attention(torch, cfg, slots, blk, lens, flush, *, int8):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        gather_kv, paged_attention_int8_dequant_ref, paged_attention_ref,
    )

    op = ops.paged_attention_int8 if int8 else ops.paged_attention
    ref = paged_attention_int8_dequant_ref if int8 else paged_attention_ref
    pools = [torch.int8] if int8 else [torch.bfloat16, torch.float32]
    main_err = None
    n_checked = 0
    for pool in pools:
        # the serving lens, then lens on and beside split boundaries, a
        # window starting inside a split and a 4096-key row
        for case_lens, var in (
                (lens, dict()), (lens, dict(window=100, start=True)),
                (split_lens(cfg, blk, pool, 544), dict()),
                (split_lens(cfg, blk, pool, 544), dict(window=100,
                                                       start=True)),
                (split_lens(cfg, blk, pool, 4096), dict(window=1000,
                                                        start=True))):
            args, kw = attention_case(torch, cfg, slots, case_lens,
                                      pool_dtype=pool, int8=int8, blk=blk,
                                      **var)
            if int8:
                args = (args[0].bfloat16(),) + args[1:]
            out = op(*args, **kw)
            want = ref(*args, **kw)
            torch.cuda.synchronize()
            # bf16 outputs: both sides round f32 to bf16, one ulp apart at
            # most (2^-8 relative); f32 outputs: flash reordering only
            tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
            torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                       rtol=tol)
            if not torch.all(out[0] == 0):
                raise AssertionError("a lens == 0 row is not zero")
            err = (out.float() - want.float()).abs().max().item()
            if case_lens is lens and not var and pool in (torch.bfloat16,
                                                          torch.int8):
                main_err = err
            n_checked += 1
    # timing at the serving shape: bf16 q, bf16 or int8 pools, ragged lens
    args, kw = attention_case(torch, cfg, slots, lens,
                              pool_dtype=torch.int8 if int8 else torch.bfloat16,
                              int8=int8, blk=blk)
    if int8:
        args = (args[0].bfloat16(),) + args[1:]
    q, kp, vp, table, lens_t = args
    k = gather_kv(kp, table)
    v = gather_kv(vp, table)
    if int8:  # the yardstick attends the dequantized K/V in bf16
        es = lambda s: s[table.long()].repeat_interleave(blk, 1)[:, None, :, None]  # noqa: E731
        k = (k.float() * es(kw["k_scale"])).bfloat16()
        v = (v.float() * es(kw["v_scale"])).bfloat16()
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < lens_t[:, None])[:, None, None, :]
    mask[0] = True  # SDPA needs one key per row; row 0 is the lens == 0 row
    kernel_ms = timed(torch, lambda: op(*args, **kw), 50, flush)
    plain_ms = timed(torch, lambda: ref(*args, **kw), 20, flush)
    sdpa = dict(attn_mask=mask, enable_gqa=True)
    try:
        F.scaled_dot_product_attention(q, k, v, **sdpa)
    except TypeError:  # a PyTorch without enable_gqa: expand the KV heads
        group = cfg.n_heads // cfg.n_kv_heads
        k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        sdpa = dict(attn_mask=mask)
    library_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa), 50, flush)
    dev_ms, dev_ops = device_ms(torch, lambda: op(*args, **kw), flush)
    lib_dev_ms, lib_ops = device_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), flush)
    tokens = int(lens_t.sum().item())
    esz = 1 if int8 else 2
    nblocks = sum(-(-int(x) // blk) for x in lens)
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + 2 * tokens * cfg.n_kv_heads * cfg.hd * esz  # K and V once
              + 4 * (nblocks + slots) + (8 * nblocks if int8 else 0))
    ops_n = 4 * tokens * cfg.n_heads * cfg.hd
    b_ms, b_by = bound(nbytes, ops_n, "int8" if int8 else "bf16")
    kern = ops.KERNEL_INT8 if int8 else ops.KERNEL
    name = "paged_attention_int8" if int8 else "paged_attention"
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        replaces=kern.replaces.split()[0], max_abs_err=main_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, device_ms=dev_ms, device_ops=dev_ops,
        library_device_ms=lib_dev_ms, library_device_ops=lib_ops,
        grid=ops.launch_grid(q, kp, table), cases_checked=n_checked,
        shape=f"B={slots} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.hd} "
              f"blk={blk} lens={list(lens)}")


def check_verify(torch, cfg, slots, blk, lens, qlen, flush, *, int8):
    """Kernels B4/B5 (small-q verify) at glm4-9b's shapes: allclose with the
    plain version; at Q = 1, and in row 0 at any Q, bit-equal to B1/B2."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        gather_kv, paged_attention_verify_int8_dequant_ref,
        paged_attention_verify_ref,
    )

    op = ops.paged_attention_verify_int8 if int8 else ops.paged_attention_verify
    dec = ops.paged_attention_int8 if int8 else ops.paged_attention
    ref = (paged_attention_verify_int8_dequant_ref if int8
           else paged_attention_verify_ref)
    def at_least_1(xs):                       # verify rows attend lens ≥ 1
        return [max(x, 1) for x in xs]

    lens = at_least_1(lens)

    pools = [torch.int8] if int8 else [torch.bfloat16, torch.float32]
    cases = [(pools[0], lens, dict()),
             (pools[-1], lens, dict(window=100, start=True))]
    for pool in pools:  # split boundaries, a window inside a split, 4096 keys
        cases += [(pool, at_least_1(split_lens(cfg, blk, pool, 544)), dict()),
                  (pool, at_least_1(split_lens(cfg, blk, pool, 4096)),
                   dict(window=1000, start=True))]
    main_err = None
    for pool, case_lens, var in cases:
        args, kw = attention_case(torch, cfg, slots, case_lens,
                                  pool_dtype=pool, int8=int8, blk=blk,
                                  qlen=qlen, **var)
        if int8:
            args = (args[0].bfloat16(),) + args[1:]
        out = op(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - want.float()).abs().max().item()
        if case_lens is lens and not var:
            main_err = err
        q1 = args[0][:, :, :1].contiguous()
        d1 = dec(q1, *args[1:], **kw)
        if not torch.equal(op(q1, *args[1:], **kw), d1):
            raise AssertionError(f"{op.__name__} at Q=1 is not bit-equal to "
                                 f"{dec.__name__} ({pool}, {var})")
        if not torch.equal(out[:, :, :1], d1):
            raise AssertionError(f"{op.__name__} row 0 is not bit-equal to "
                                 f"{dec.__name__} ({pool}, {var})")
    # timing at the serving shape: bf16 q, bf16 or int8 pools
    args, kw = attention_case(torch, cfg, slots, lens,
                              pool_dtype=torch.int8 if int8 else torch.bfloat16,
                              int8=int8, blk=blk, qlen=qlen)
    if int8:
        args = (args[0].bfloat16(),) + args[1:]
    q, kp, vp, table, lens_t = args
    k = gather_kv(kp, table)
    v = gather_kv(vp, table)
    if int8:  # the yardstick attends the dequantized K/V in bf16
        es = lambda s: s[table.long()].repeat_interleave(blk, 1)[:, None, :, None]  # noqa: E731
        k = (k.float() * es(kw["k_scale"])).bfloat16()
        v = (v.float() * es(kw["v_scale"])).bfloat16()
    eff = lens_t[:, None] + torch.arange(qlen, device=q.device)[None, :]
    mask = (torch.arange(k.shape[2], device=q.device)[None, None, :]
            < eff[:, :, None])[:, None]            # [B, 1, Q, S]
    kernel_ms = timed(torch, lambda: op(*args, **kw), 50, flush)
    plain_ms = timed(torch, lambda: ref(*args, **kw), 20, flush)
    sdpa = dict(attn_mask=mask, enable_gqa=True)
    try:
        F.scaled_dot_product_attention(q, k, v, **sdpa)
    except TypeError:  # a PyTorch without enable_gqa: expand the KV heads
        group = cfg.n_heads // cfg.n_kv_heads
        k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        sdpa = dict(attn_mask=mask)
    library_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa), 50, flush)
    dev_ms, dev_ops = device_ms(torch, lambda: op(*args, **kw), flush)
    lib_dev_ms, lib_ops = device_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), flush)
    # bytes: q in and out once, each row's K/V up to its last query's
    # length once, table entries, lens, per-block scales
    keys = [x + qlen - 1 for x in lens]
    esz = 1 if int8 else 2
    nblocks = sum(-(-x // blk) for x in keys)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * sum(keys) * cfg.n_kv_heads * cfg.hd * esz
              + 4 * (nblocks + slots) + (8 * nblocks if int8 else 0))
    ops_n = sum(4 * (x + j) * cfg.n_heads * cfg.hd
                for x in lens for j in range(qlen))
    b_ms, b_by = bound(nbytes, ops_n, "int8" if int8 else "bf16")
    kern = ops.KERNEL_VERIFY_INT8 if int8 else ops.KERNEL_VERIFY
    return dict(
        name=kern.name, route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        replaces=kern.replaces.split()[0], max_abs_err=main_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, device_ms=dev_ms, device_ops=dev_ops,
        library_device_ms=lib_dev_ms, library_device_ops=lib_ops,
        grid=ops.launch_grid(q, kp, table), cases_checked=len(cases),
        shape=f"B={slots} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.hd} "
              f"Q={qlen} blk={blk} lens={lens}")


# gemma3-4b's decode rows for B1/B2: a ring table 65 entries wide (a window
# of 1024 at block_len 16, plus one write-ahead block), entry 0 at absolute
# position start = first·16, lens − start from 1 to 1040; and a G layer's
# full-history table at max_len 4128 (258 entries) with rows up to 4096 keys
RING_FIRSTS = (0, 1, 62, 185)
# qwen3-moe-30b-a3b's decode rows for B1/B2/B4/B5 (phase 2): 8 rows, one
# empty, up to a 4096-key row (32 query heads on 4 kv heads of 128)
MOE_LENS = (0, 17, 130, 544, 1000, 2047, 3000, 4096)
RING_RELS = (1, 15, 16, 17, 500, 1008, 1023, 1024, 1025, 1039, 1040)
FULL_LENS = (1, 1000, 1024, 1025, 2047, 3000, 4095, 4096)


def check_ring_attention(torch, cfg, blk, max_len, flush, *, int8):
    """B1 (``int8`` False: f32 and bf16 pools) or B2 (int8 pools) at
    gemma3-4b's geometry on the ring rows and the full-history rows above,
    allclose with the plain version at the tolerances of
    ``check_attention``; then both row sets timed at 8 serving rows (the
    ring's steady state, every row's window full; a G layer's rows),
    beside the plain version, SDPA over the gathered keys and the bound of
    the keys the window admits."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        gather_kv, paged_attention_int8_dequant_ref, paged_attention_ref,
    )

    window = cfg.local_window
    full_w = -(-max_len // blk)
    ring_w = -(-window // blk) + 1
    op = ops.paged_attention_int8 if int8 else ops.paged_attention
    ref = paged_attention_int8_dequant_ref if int8 else paged_attention_ref
    pools = [torch.int8] if int8 else [torch.float32, torch.bfloat16]
    errs, n_checked = {}, 0
    for pool in pools:
        for label, rels, kw_case in (
                ("ring", RING_RELS, dict(width=ring_w, firsts=RING_FIRSTS)),
                ("full", FULL_LENS, dict(width=full_w))):
            args, kw = attention_case(torch, cfg, len(rels), rels,
                                      pool_dtype=pool, int8=int8, blk=blk,
                                      window=window, seed=7, **kw_case)
            if int8:   # the serving path's bf16 queries
                args = (args[0].bfloat16(),) + args[1:]
            out = op(*args, **kw)
            want = ref(*args, **kw)
            torch.cuda.synchronize()
            tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
            torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                       rtol=tol)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{op.__name__} {label}: not finite")
            errs[f"{label} {str(pool).split('.')[-1]}"] = (
                out.float() - want.float()).abs().max().item()
            n_checked += 1
    timing = {}
    pool = torch.int8 if int8 else torch.bfloat16
    for label, rels, kw_case in (
            ("ring", tuple(range(1033, 1041)),
             dict(width=ring_w, firsts=RING_FIRSTS)),
            ("full", (100, 300, 544, 1000, 1020, 2000, 3000, 4096),
             dict(width=full_w))):
        args, kw = attention_case(torch, cfg, len(rels), rels,
                                  pool_dtype=pool, int8=int8, blk=blk,
                                  window=window, seed=11, **kw_case)
        if int8:
            args = (args[0].bfloat16(),) + args[1:]
        q, kp, vp, table, lens = args
        k, v = gather_kv(kp, table), gather_kv(vp, table)
        if int8:  # the yardstick attends the dequantized K/V in bf16
            es = lambda s: s[table.long()].repeat_interleave(blk, 1)[:, None, :, None]  # noqa: E731
            k = (k.float() * es(kw["k_scale"])).bfloat16()
            v = (v.float() * es(kw["v_scale"])).bfloat16()
        pos = torch.arange(k.shape[2], device=q.device)[None, :]
        if kw["start"] is not None:
            pos = pos + kw["start"][:, None]
        mask = ((pos < lens[:, None]) & (pos >= lens[:, None] - window)
                )[:, None, None, :]
        sdpa = dict(attn_mask=mask, enable_gqa=True)
        try:
            F.scaled_dot_product_attention(q, k, v, **sdpa)
        except TypeError:  # a PyTorch without enable_gqa
            group = cfg.n_heads // cfg.n_kv_heads
            k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
            sdpa = dict(attn_mask=mask)
        keys = sum(min(r, window) for r in rels)     # what the window admits
        esz = 1 if int8 else 2
        nblocks = sum(-(-min(r, window) // blk) for r in rels)
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * keys * cfg.n_kv_heads * cfg.hd * esz
                  + 4 * (nblocks + 2 * len(rels))
                  + (8 * nblocks if int8 else 0))
        b_ms, b_by = bound(nbytes, 4 * keys * cfg.n_heads * cfg.hd,
                           "int8" if int8 else "bf16")
        dev_ms, _ = device_ms(torch, lambda: op(*args, **kw), flush)
        timing[label] = dict(
            ms=timed(torch, lambda: op(*args, **kw), 50, flush),
            device_ms=dev_ms,
            plain_ms=timed(torch, lambda: ref(*args, **kw), 10, flush),
            library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, **sdpa), 50, flush),
            bound_ms=b_ms, bound_by=b_by,
            grid=list(ops.launch_grid(q, kp, table)),
            rows=f"{len(rels)} rows, lens-start {rels[0]}..{rels[-1]}, "
                 f"{table.shape[1]} entries")
    return dict(name="paged_attention_int8" if int8 else "paged_attention",
                errs=errs, cases_checked=n_checked, timing=timing)


def check_int8_gemm_shapes(torch, cfg, ms, flush):
    """B3 bit-exact on ``cfg``'s seven projections (K-major weights) at
    each M of ``ms``, all three activations; one layer's seven projections
    at the largest M timed (event ms, L2 flushed by a read before each
    layer) beside its bound."""
    from repro_torch.core import quant
    from repro_torch.kernels.int8_gemm import ops
    from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
              "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    layer = {}
    for name, (k, n) in shapes.items():
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8).mT
        scale = torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev))
        mult, shift = quant.quantize_to_fixed_point(scale)
        bias = torch.randint(-20000, 20000, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        layer[name] = (w, bias, mult.to(torch.int32), shift.to(torch.int32))
    n_checked = 0
    for m in ms:
        for name, (w, bias, mult, shift) in layer.items():
            x = torch.randint(-127, 128, (m, w.shape[0]), generator=g,
                              device=dev, dtype=torch.int8)
            for act in ("none", "relu", "gelu"):
                scales = (4.0 / 127, 4.0 / 127) if act == "gelu" else None
                y = ops.int8_gemm_cuda(x, w, bias, mult, shift,
                                       activation=act, act_scales=scales)
                want = int8_gemm_ref(x, w, bias, mult, shift,
                                     activation=act, act_scales=scales)
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise AssertionError(
                        f"int8_gemm {cfg.name} {name} M={m} {act}: "
                        f"{(y != want).sum().item()} outputs differ")
                n_checked += 1
    m = max(ms)
    args = [(torch.randint(-127, 128, (m, w.shape[0]), generator=g,
                           device=dev, dtype=torch.int8), w, b, mu, sh)
            for w, b, mu, sh in layer.values()]
    nbytes = sum(m * w.shape[0] + w.numel() + 12 * w.shape[1]
                 + m * w.shape[1] for w, *_ in layer.values())
    ops_n = sum(2 * m * w.shape[0] * w.shape[1] for w, *_ in layer.values())
    b_ms, b_by = bound(nbytes, ops_n, "int8")

    def kernel():
        for a in args:
            ops.int8_gemm_cuda(*a)

    return dict(cases_checked=n_checked, m=m,
                ms=timed(torch, kernel, 20, flush), bound_ms=b_ms,
                bound_by=b_by, device_ms=device_ms(torch, kernel, flush)[0],
                shapes={k: list(v) for k, v in shapes.items()})


def check_ssd_scan(torch, cfg, lengths, main_len):
    """Kernel B8 at mamba2-2.7b's widths (one prompt: B = 1, H = 80, P = 64,
    N = 128, G = 1) against ``ssd_scan_chunked_ref`` over the zero-padded
    sequence: y and the final state allclose (rtol 1e-4, atol 1e-4·max|·|;
    float32, only the order of additions differs), y bit-equal without the
    state, plus a G = 2 case (40 heads a group). Times per S on the event
    clock and as ``torch.profiler`` sees the call (device time, by kernel
    at ``main_len``, and CUDA launches a call), with the grids of its
    launches."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref

    dev = torch.device("cuda")
    d_inner = cfg.expand * cfg.d_model
    h, p, n = d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state

    def case(s, g=cfg.ssm_ngroups):
        gen = torch.Generator(device=dev).manual_seed(SEED + s + g)
        # Δ·A as the model makes it: softplus(dt) · -exp(a_log), a_log = 1
        dta = -torch.rand((1, h, s), generator=gen, device=dev) * 2.0
        x = torch.randn((1, h, s, p), generator=gen, device=dev)
        bm = torch.randn((1, g, s, n), generator=gen, device=dev) * 0.3
        cm = torch.randn((1, g, s, n), generator=gen, device=dev) * 0.3
        return dta, x, bm, cm

    def plain(args, s):
        return ssd_scan_chunked_ref(*args, chunk=min(128, s),
                                    return_state=True)

    def call(args, s):
        return ops.ssd_scan_cuda(*args, chunk=min(128, s), return_state=True)

    errs = {}
    for s, g in [(s, cfg.ssm_ngroups) for s in lengths] + [(300, 2)]:
        args = case(s, g)
        y, st = call(args, s)
        y_only = ops.ssd_scan_cuda(*args, chunk=min(128, s))
        want_y, want_st = plain(args, s)
        torch.cuda.synchronize()
        for got, want in ((y, want_y), (st, want_st)):
            torch.testing.assert_close(
                got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        if not torch.equal(y, y_only):
            raise AssertionError(f"ssd_scan S={s}: y differs without state")
        errs[(s, g)] = max((y - want_y).abs().max().item(),
                           (st - want_st).abs().max().item())
    args = case(main_len)
    kernel_ms = timed(torch, lambda: call(args, main_len), 50)
    plain_ms = timed(torch, lambda: plain(args, main_len), 20)
    # device time with L2 as a prefill finds it (the inputs just written)
    by_kernel = {}
    dev_ms, dev_ops = device_ms(torch, lambda: call(args, main_len),
                                lambda: None, by_op=by_kernel)
    per_len = {}
    for s in lengths:
        a = case(s)
        d_ms, d_ops = device_ms(torch, lambda a=a, s=s: call(a, s),
                                lambda: None)
        _, launches, grids = ops.plan(1, h, cfg.ssm_ngroups, s, n, p,
                                      min(128, s), True)
        per_len[s] = dict(ms=timed(torch, lambda a=a, s=s: call(a, s), 20),
                          device_ms=d_ms, device_ops=d_ops,
                          launches=launches, grids=grids)
    # bytes: dta, x, B, C in once; y and the state out once. Operations
    # the function needs per chunk of L rows: C·Bᵀ over τ ≤ t once per
    # group (L·(L+1)·N), and per head scores·x over τ ≤ t (L·(L+1)·P),
    # Bᵀ·x (2·L·N·P) and, past the first chunk (which enters with a zero
    # state), C·state (2·L·N·P). The kernel runs them as split TF32
    # (three tensor-core products each); the f32 CUDA-core bound beside
    g = cfg.ssm_ngroups
    nbytes = 4 * (h * main_len * (1 + 2 * p) + 2 * g * main_len * n
                  + h * n * p)
    full, tail = divmod(main_len, 128)
    ops_n = sum(g * rows * (rows + 1) * n
                + h * (rows * (rows + 1) * p + (4 if c else 2) * rows * n * p)
                for c, rows in enumerate([128] * full + ([tail] if tail
                                                         else [])))
    b_ms, b_by = bound(nbytes, 3 * ops_n, "tf32")
    _, launches, grids = ops.plan(1, h, g, main_len, n, p, 128, True)
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bound_f32_ms=bound(nbytes, ops_n, "f32")[0],
        device_ms=dev_ms, device_ops=dev_ops, by_kernel=by_kernel,
        launches_per_call=launches,
        grids=grids, main_len=main_len,
        shape=f"B=1 H={h} P={p} N={n} G={cfg.ssm_ngroups} S={main_len} "
              f"chunk=128, state out",
        errs={f"S={s},G={g}": e for (s, g), e in errs.items()},
        per_len=per_len)


def check_rglru(torch, cfg, lengths, main_len):
    """Kernel B9 at recurrentgemma-9b's width (one prompt: B = 1, D =
    lru_width = 4096, and a B = 3 case) against ``rglru_ref``, with f32
    ``log_a`` and bf16 ``u`` (the model's dtypes) or f32 ``u``: f32 output
    allclose (rtol 1e-5, atol 1e-5·max|h|), bf16 output at most one bf16
    ulp apart."""
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import rglru_ref

    dev = torch.device("cuda")
    d = cfg.lru_width

    def case(b, s, u_dtype):
        gen = torch.Generator(device=dev).manual_seed(SEED + s + b)
        # log_a as the model makes it: −8·softplus(Λ)·r, r a sigmoid
        lam = torch.randn((d,), generator=gen, device=dev)
        r = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r
        u = torch.randn((b, s, d), generator=gen, device=dev).to(u_dtype)
        return log_a, u

    errs = {}
    # lengths at the kernel's 64-row tile (63 / 64 / 65) and past its ring
    # of three tiles in flight (192 / 193), and B = 3
    edges = [(1, s) for s in (63, 64, 65, 192, 193)] + [(3, 300), (3, 2300)]
    for b, s in [(1, s) for s in lengths] + edges:
        for u_dtype in (torch.bfloat16, torch.float32):
            log_a, u = case(b, s, u_dtype)
            h = ops.rglru_cuda(log_a, u)
            want = rglru_ref(log_a, u)
            torch.cuda.synchronize()
            g, w = h.float(), want.float()
            if u_dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=1e-5,
                                           atol=1e-5 * float(w.abs().max()))
            else:
                mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                bad = int(((g - w).abs() > ulp).sum())
                if bad:
                    raise AssertionError(f"rglru B={b} S={s} bf16: {bad} "
                                         f"outputs more than one ulp apart")
            name = "bf16" if u_dtype == torch.bfloat16 else "f32"
            errs[f"B={b},S={s},{name}"] = (g - w).abs().max().item()
    log_a, u = case(1, main_len, torch.bfloat16)
    kernel_ms = timed(torch, lambda: ops.rglru_cuda(log_a, u), 50)
    plain_ms = timed(torch, lambda: rglru_ref(log_a, u), 5)
    # per S: event ms, device ms (torch.profiler; L2 as a prefill finds it,
    # the inputs just written), the bytes bound and the launch plan
    per_len = {}
    for s in lengths:
        a = case(1, s, torch.bfloat16)
        d_ms, _ = device_ms(torch, lambda a=a: ops.rglru_cuda(*a),
                            lambda: None)
        p = ops.plan(1, s, d)
        per_len[s] = dict(
            ms=timed(torch, lambda a=a: ops.rglru_cuda(*a), 20),
            device_ms=d_ms, bound_ms=bound(s * d * 8, 7 * s * d, "f32")[0],
            blocks=p.blocks[0] * p.blocks[1], tiles=p.tiles)
    # bytes: log_a (f32) and u (bf16) in once, h (bf16) out once; per
    # element 2·log_a, β·u, a·h, the add and exp, expm1, sqrt
    n = main_len * d
    b_ms, b_by = bound(n * (4 + 2 + 2), 7 * n, "f32")
    return dict(
        name="rglru", route="cuda",
        source="src/repro_torch/kernels/rglru/csrc/rglru.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=per_len[main_len]["device_ms"],
        shape=f"B=1 S={main_len} D={d}, f32 log_a, bf16 u and h",
        errs=errs, per_len=per_len)


def ita_inputs(torch, gen, b, hq, hkv, sq, skv, d, *, saturated=False):
    """int8 q, k, v [B, H, S, D] on the card: unit normals quantized as
    ``int8_attention`` quantizes them (q pre-scaled by 1/√d; scale 4/127),
    or uniform int8 (every logit saturates)."""
    shapes = [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)]
    if saturated:
        return [torch.randint(-127, 128, sh, generator=gen, device="cuda",
                              dtype=torch.int8) for sh in shapes]
    xs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    xs[0] = xs[0] * d ** -0.5
    return [torch.clamp(torch.round(x * (127 / 4.0)), -127, 127)
            .to(torch.int8) for x in xs]


def ita_bound(q, k, causal, ops_a_pair=20, by=False):
    """B6's bound for q [B, Hq, S, D] over k (and v) [B, Hkv, S, D]: q and
    the output, k and v in and out once; per kept (row, key) pair the two
    int8 products over D (tensor-core int8) and ``ops_a_pair`` scalar int32
    operations on the CUDA cores (20 in this body: requantize 7 and its
    range test 2, tile max 1, exponent 4, exp2_fixed and p8 5, packing p8
    1; ita_attention.cu's header; the first body's 26: requantize 9,
    alpha 3, tile max 1, exponent 2, exp2_fixed 8, p8 2, sum 1). The mask
    keeps min(r + 1, S) keys of row r when causal, all S when not."""
    b, hq, s, d = q.shape
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    res = bound(2 * q.numel() + 2 * k.numel(), 4 * d * pairs, "int8",
                int32=ops_a_pair * pairs)
    return res if by else res[0]


def check_ita_attention(torch, cfg, flush):
    """Kernel B6 at each width phase 6 runs (MobileBERT, Whisper-Tiny
    encoder, DINOv2-S, and the glm4-9b prompt: B = 1, 32 query / 2 kv heads,
    S = 2048, D = 128, causal, 128-row tiles, the timed case), at four more
    cases and at the saturated floor corner, each bit-exact against its
    plain version on the card."""
    import torch.nn.functional as F

    from repro_torch.kernels.ita_attention import ops
    from repro_torch.kernels.ita_attention.ref import (
        ita_attention_gqa_ref as ita_plain,
    )

    sc = 4.0 / 127
    real = dict(qk_scale=sc * sc, v_scale=sc, out_scale=sc)
    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 2048
    # name, (B, Hq, Hkv, S, D), tiles, causal, saturated, scales
    cases = [(name, (1, nq, nkv, sl, d), blk, blk, causal, False, real)
             for name, _, nq, nkv, sl, d, causal, blk, _ in ita_widths(cfg)]
    cases += [
        ("no GQA", (2, 8, 8, 512, 64), 128, 128, True, False, real),
        ("block_kv 64", (1, hq, hkv, 1024, hd), 128, 64, True, False, real),
        ("block_kv 125", (1, 6, 6, 1000, 64), 125, 125, True, False, real),
        ("saturated", (1, 4, 2, 256, 48), 64, 32, True, True,
         dict(qk_scale=1e-3, v_scale=0.03, out_scale=0.02)),
        # the redesign's edges: 137-key tiles (padded to 160) causal; a
        # GQA group of 16 at an S its 16-position blocks do not divide
        ("block_kv 137 causal", (1, 6, 6, 1370, 64), 137, 137, True, False,
         real),
        ("group 16, S 1000", (1, hq, hkv, 1000, hd), 125, 125, True, False,
         real),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_checked = 0
    main = None
    for name, (b, nq, nkv, sl, d), bq, bkv, causal, sat, scales in cases:
        q, k, v = ita_inputs(torch, gen, b, nq, nkv, sl, sl, d,
                             saturated=sat)
        kw = dict(scales, causal=causal, block_q=bq, block_kv=bkv)
        y = ops.ita_attention_cuda(q, k, v, **kw)
        want = ita_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"ita_attention {name}: "
                                 f"{int((y != want).sum())} outputs differ")
        n_checked += 1
        if name == "glm4-9b prompt":
            main = (q, k, v, kw)
    # the saturated causal corner: every logit at the exponent floor, so
    # the skipped tiles above the diagonal would change the result; a
    # 60-key tile (padded to 64 in the kernel) keeps its padding at p8 = 0
    d = 64
    for sl, tile in ((128, 64), (120, 60)):
        q = torch.full((1, 1, sl, d), 127, dtype=torch.int8, device="cuda")
        k = torch.full((1, 1, sl, d), -127, dtype=torch.int8, device="cuda")
        v = ita_inputs(torch, gen, 1, 1, 1, sl, sl, d, saturated=True)[2]
        for amax in (1000.0, 10.0):
            kw = dict(qk_scale=1.0, v_scale=1.0, out_scale=1.0, causal=True,
                      logit_amax=amax, block_q=tile, block_kv=tile)
            if not torch.equal(ops.ita_attention_cuda(q, k, v, **kw),
                               ita_plain(q, k, v, **kw)):
                raise AssertionError(f"ita_attention floor corner (tile "
                                     f"{tile}, logit_amax {amax}) differs")
            n_checked += 1

    # each phase-6 width: event and device ms a call, and the launch plan
    per_width = {}
    for name, _, nq, nkv, sl, d, causal, blk, _ in ita_widths(cfg):
        x = ita_inputs(torch, gen, 1, nq, nkv, sl, sl, d)
        kw = dict(real, causal=causal, block_q=blk, block_kv=blk)
        d_ms, _ = device_ms(torch, lambda x=x, kw=kw:
                            ops.ita_attention_cuda(*x, **kw), flush)
        p = ops.plan(1, nq, nkv, sl, d, blk)
        per_width[name] = dict(
            ms=timed(torch, lambda x=x, kw=kw: ops.ita_attention_cuda(
                *x, **kw), 20, flush),
            device_ms=d_ms, bound_ms=ita_bound(x[0], x[1], causal),
            blocks=p.blocks, warps=p.warps, heads=p.heads, stages=p.stages,
            smem=p.smem)

    q, k, v, kw = main
    kernel_ms = timed(torch, lambda: ops.ita_attention_cuda(q, k, v, **kw),
                      20, flush)
    plain_ms = timed(torch, lambda: ita_plain(q, k, v, **kw), 3, flush)
    # a different function, for context only: float SDPA at the same shape
    g = hq // hkv
    qb, kb, vb = (x.to(torch.bfloat16) for x in
                  (q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
    sdpa_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True), 20, flush)
    b_ms, b_by = ita_bound(q, k, True, by=True)
    return dict(
        name="ita_attention", route="cuda",
        source="src/repro_torch/kernels/ita_attention/csrc/ita_attention.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        bound_26_ms=ita_bound(q, k, True, ops_a_pair=26),
        device_ms=per_width["glm4-9b prompt"]["device_ms"],
        shape=f"B=1 Hq={hq} Hkv={hkv} S={s} D={hd} causal, 128-row tiles",
        cases_checked=n_checked, sdpa_ms=sdpa_ms, per_width=per_width)


# B7's integer instructions a logit in the staged body's loops, shared loads
# left out (int_softmax.cu's header; counted in the compiled SASS), and the
# first body's 17 operations (max 1, exponent 4 and exp2_fixed 8 once, sum
# 1, e * 255 + den / 2 and the divide 3), priced beside
B7_OPS = 8.2
B7_OPS_FIRST = 17


def smax_logits(torch, gen, r, c, scale):
    """int8 logits [r, c] on the card: normals of spread 3 quantized at
    ``scale``."""
    x = torch.randn((r, c), generator=gen, device="cuda") * 3.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int_softmax_widths(torch, cfg, flush, read_flush):
    """B7 at each paper network's per-layer [H·S, S] logits (phase 6):
    bit-exact against ``int_softmax_ref``; event and device ms a call with
    L2 flushed before each by ``flush`` (a 256 MB write: L2 starts the call
    full of dirty lines), device ms with L2 flushed by ``read_flush`` (a
    read: L2 starts clean); ``Tensor.copy_`` of the same bytes after each
    flush, a yardstick of the memory path (not the same function); the
    bounds (bytes; operations at this body's and at the first body's
    count)."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s_logit = 10.0 / 127
    per_width = {}
    for name, _, hq, _, sl, _, _, _, paper in ita_widths(cfg):
        if not paper:
            continue
        x = smax_logits(torch, gen, hq * sl, sl, s_logit)

        def call(x=x):
            return ops.int_softmax_cuda(x, logit_scale=s_logit)

        if not torch.equal(call(), int_softmax_ref(x, logit_scale=s_logit)):
            raise AssertionError(f"int_softmax at {name}: "
                                 f"{tuple(x.shape)} differs")
        y = torch.empty_like(x)
        n = x.numel()

        def copy(x=x, y=y):
            return y.copy_(x)

        per_width[name] = dict(
            rows=hq * sl, cols=sl, ms=timed(torch, call, 50, flush),
            device_ms=device_ms(torch, call, flush)[0],
            device_ms_read=device_ms(torch, call, read_flush)[0],
            copy_ms=device_ms(torch, copy, flush)[0],
            copy_ms_read=device_ms(torch, copy, read_flush)[0],
            bound_bytes_ms=bound(2 * n, 0, "int32")[0],
            bound_ops_ms=B7_OPS * n / PEAK_OPS["int32"] * 1e3,
            bound_17_ms=B7_OPS_FIRST * n / PEAK_OPS["int32"] * 1e3)
    return per_width


def check_int_softmax(torch, cfg, flush, read_flush):
    """Kernel B7 at each paper network's per-layer logits (phase 6; DINOv2-S's
    [6·1370, 1370] is the entry's), at ragged rows and columns (row starts
    on every residue mod 16, rows at the staged body's limit and either
    side of it, one row of 2^22), a row holding -128 and 127, a view off
    the 16-byte grid and logit scales 0.001 to 60, bit-exact against
    ``int_softmax_ref``; the per-width times of ``int_softmax_widths`` and
    the launch plan."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    s_logit = 10.0 / 127
    lim = ops.STAGE_COLS
    # (rows, cols, scale, kind): "extremes" sets each row's first logits to
    # -128 and 127 (k = 255); "offset" takes the rows from a view 3 bytes
    # off the 16-byte grid
    cases = [(1001, 999, 0.06, ""), (3, 1, s_logit, ""),
             (5, 4099, 60.0, ""), (1, 100003, 0.06, ""),
             (4001, 333, s_logit, ""), (9, lim - 1, s_logit, ""),
             (9, lim, 0.06, ""), (9, lim + 1, s_logit, ""),
             (1, 1 << 22, 0.06, ""), (300, 1370, 0.001, ""),
             (64, 1370, s_logit, "extremes"), (33, 1370, 60.0, "extremes"),
             (64, 1370, s_logit, "offset"), (7, 20001, 0.06, "offset")]
    for r, c, scale, kind in cases:
        if kind == "offset":
            x = smax_logits(torch, gen, 1, r * c + 16, scale)[0, 3:3 + r * c]
            x = x.view(r, c)
        else:
            x = smax_logits(torch, gen, r, c, scale)
        if kind == "extremes":
            x[:, 0], x[:, -1] = -128, 127
        y = ops.int_softmax_cuda(x, logit_scale=scale)
        want = int_softmax_ref(x, logit_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"int_softmax [{r}, {c}] scale {scale} "
                                 f"{kind}: {int((y != want).sum())} values "
                                 f"differ")
    per_width = int_softmax_widths(torch, cfg, flush, read_flush)
    for v in per_width.values():
        v["plan"] = ops.plan(v["rows"], v["cols"])._asdict()
    main = per_width["DINOv2-S"]
    x = smax_logits(torch, gen, main["rows"], main["cols"], s_logit)
    plain_ms = timed(torch, lambda: int_softmax_ref(x, logit_scale=s_logit),
                     10, flush)
    # bytes: the int8 logits in, the uint8 probabilities out; operations:
    # B7_OPS scalar int32 an element on the CUDA cores
    b_ms, b_by = bound(2 * x.numel(), B7_OPS * x.numel(), "int32")
    return dict(
        name="int_softmax", route="cuda",
        source="src/repro_torch/kernels/int_softmax/csrc/int_softmax.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=main["ms"], plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, bound_17_ms=main["bound_17_ms"],
        device_ms=main["device_ms"],
        shape="[6x1370, 1370] int8 logits (DINOv2-S, one layer)",
        cases_checked=len(cases) + len(per_width), per_width=per_width)


# ---------------------------------------------------------------------------
# Phase 3: the port's main path at full width
# ---------------------------------------------------------------------------


def random_prompts(vocab, n_requests, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(64, 513))).astype(np.int32)
            for _ in range(n_requests)]


def hybrid_prompts(vocab, seed):
    """14 prompts of 64–512 random tokens and 2 of 2100–2300: longer than
    recurrentgemma-9b's 2048-token window."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(64, 513)) for _ in range(14)]
    lens[3:3] = [int(rng.integers(2100, 2301))]
    lens[10:10] = [int(rng.integers(2100, 2301))]
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def long_prompts(vocab, seed):
    """14 prompts of 64–512 random tokens and 2 of 3000–4000: each long one
    takes at least 6 chunks of 512 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(64, 513)) for _ in range(14)]
    lens[4:4] = [int(rng.integers(3000, 4001))]
    lens[11:11] = [int(rng.integers(3000, 4001))]
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def shared_prefix_prompts(vocab, n_requests, seed):
    """One shared 256-token prefix plus a per-request 64–256-token suffix
    with period-3 repetition (the n-gram drafter finds trailing matches)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 256)
    out = []
    for _ in range(n_requests):
        period = rng.integers(0, vocab, 3)
        suffix = np.tile(period, 86)[:int(rng.integers(64, 257))]
        out.append(np.concatenate([shared, suffix]).astype(np.int32))
    return out


def serve(torch, arch, params, prompts, slots, max_new, max_len=None,
          embeds=None, **engine_kw):
    from repro_torch.kernels.build import all_kernels
    from repro_torch.serve import EngineConfig, LLMEngine, metrics

    eng = LLMEngine(arch, params, EngineConfig(
        backend="paged", slots=slots, max_len=max_len or 512 + max_new,
        admit_window=2, scheduler="bounded", block_len=16, **engine_kw))
    for k in all_kernels():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.add_request(p, max_new_tokens=max_new,
                               embeds=None if embeds is None else embeds[i])
               for i, p in enumerate(prompts)]
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in all_kernels()}
    reqs = [eng.request(h) for h in handles]
    for r in reqs:
        if len(r.output) != max_new or r.finish_reason != "length":
            raise AssertionError(
                f"request {r.rid}: {len(r.output)} tokens, {r.finish_reason}")
    # the logits of one more decode (or verify) step over the engine's
    # pools are finite
    k = eng._spec                 # 0 where the backend opts out of spec
    if k:
        logits, _ = arch.paged_verify_step(
            params, eng.cache, torch.zeros((slots, k + 1), dtype=torch.int32,
                                           device=eng.backend.last_tok.device),
            eng.backend._tables(), qparams=eng.backend.qparams)
        want = (slots, k + 1, arch.cfg.vocab)
    else:
        logits, _ = arch.paged_decode_step(
            params, eng.cache, eng.backend.last_tok, eng.backend._tables(),
            qparams=eng.backend.qparams)
        want = (slots, arch.cfg.vocab)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    m = eng.metrics()
    return dict(
        outputs=[list(r.output) for r in reqs],
        decode_dispatches=m["decode_dispatches"],
        pool_bytes=eng.backend.pool_bytes,
        prefix_hit_blocks=eng.backend.alloc.hit_blocks,
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        decode_ms_per_iter_p50=m["iter_wall_p50_ms"],
        iter_ms_p99=m["iter_wall_p99_ms"],
        iter_ms_max=max(eng._iter_walls) * 1e3,
        jitter_ms=m["decode_iter_jitter_ms"],
        ttft_avg_s=metrics(done)["ttft_avg_s"],
        chunks=m["prefill_chunks_dispatched"],
        stalls=m["prefill_chunk_stalls"],
        iterations=m["iterations"], wall_s=wall,
        preemptions=sum(r.preemptions for r in reqs),
        prompt_tokens=int(sum(len(p) for p in prompts)),
        spec_accept_rate=m["spec_accept_rate"],
        spec_drafted=m["spec_drafted"], spec_accepted=m["spec_accepted"],
        prefix_cache_hit_rate=m.get("prefix_cache_hit_rate", 0.0),
        prefill_skip_rate=m.get("prefill_skip_rate", 0.0),
        launches=counts)


def decode_steps(torch, arch, params, slots, reps=25, prompt_len=200,
                 max_len=512, embeds=None, keep_engine=False):
    """Steady-state decode iterations of ``LLMEngine`` (every slot running
    a ``prompt_len``-token prompt): the host-clock p50 of one step, and a
    step's device time from ``torch.profiler`` — all kernels, the int8
    GEMM's and the paged-attention kernels' shares, the eight longest
    kernels by name (ms a step), and the number of kernels. ``embeds``
    (an encdec arch's frame embeddings) goes with every request;
    ``keep_engine`` returns the engine too, its slots still running."""
    import numpy as np

    from repro_torch.serve import EngineConfig, LLMEngine

    rng = np.random.default_rng(5)
    eng = LLMEngine(arch, params, EngineConfig(
        backend="paged", slots=slots, max_len=max_len, block_len=16))
    for _ in range(slots):
        eng.add_request(rng.integers(0, arch.cfg.vocab, prompt_len
                                     ).astype(np.int32), max_new_tokens=200,
                        embeds=embeds)
    for _ in range(12):           # the admissions and the first decodes
        eng.step()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 3
    with profiled(torch) as prof:
        for _ in range(n):
            eng.step()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return dict(step_ms_p50=sorted(walls)[reps // 2],
                top={e.key[:60]: round(dev_us(e) / n / 1e3, 3) for e in top},
                device_ms=sum(dev_us(e) for e in kernels) / n / 1e3,
                gemm_device_ms=sum(dev_us(e) for e in kernels
                                   if "int8_gemm" in e.key) / n / 1e3,
                attn_device_ms=sum(dev_us(e) for e in kernels
                                   if "paged_attention" in e.key) / n / 1e3,
                kernels=sum(e.count for e in kernels) / n,
                engine=eng if keep_engine else None)


def small_input_agreement(torch, quant):
    """Smoke-size glm4-9b in float32 through the kernels on the card and
    through the plain versions on the CPU: same greedy tokens."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("glm4-9b"),
                              dtype="float32", serve_quant=quant)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40))
                            ).astype(np.int32) for _ in range(6)]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend="paged", slots=4, max_len=64,
                                     admit_window=2),
                        device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device] = [eng.request(h).output for h in hs]
    same = sum(a == b for x, y in zip(outs["cuda"], outs["cpu"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in outs["cpu"])
    if same / total < 0.9:
        raise AssertionError(f"card vs CPU greedy tokens: {same}/{total} agree")
    return same, total


def small_input_spec_agreement(torch, quant):
    """Smoke-size glm4-9b in float32 on the card with the prefix cache:
    spec_tokens=4 gives spec_tokens=0's greedy tokens."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("glm4-9b"),
                              dtype="float32", serve_quant=quant)
    arch = registry.build(cfg)
    params = bridge.params_from_numpy(
        bridge.numpy_params(arch.schema(), seed=SEED), "cuda")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 19)
    prompts = [np.concatenate([shared, np.tile(rng.integers(0, cfg.vocab, 3),
                                               8)[:int(rng.integers(4, 20))]])
               for _ in range(6)]
    outs = {}
    for k in (0, 4):
        eng = LLMEngine(arch, params, EngineConfig(
            backend="paged", slots=4, max_len=64, admit_window=2, block_len=8,
            spec_tokens=k, prefix_cache=True), device="cuda")
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[k] = [eng.request(h).output for h in hs]
    same = sum(a == b for x, y in zip(outs[4], outs[0]) for a, b in zip(x, y))
    total = sum(len(x) for x in outs[0])
    if same / total < 0.9:
        raise AssertionError(f"spec on vs off greedy tokens: {same}/{total}")
    return same, total


def small_input_chunked_agreement(torch, quant):
    """Smoke-size glm4-9b in float32 on the card with chunked prefill
    (chunks of one and two blocks, prefix cache off and on), against the
    CPU's chunked run (≥ 90 % equal greedy tokens) and the card's
    monolithic run (≥ 90 % on float pools). On int8 pools a chunk boundary
    is a suffix resume over the dequantized int8 K/V, where a monolithic
    prefill attends float K/V: a different function in both packages (the
    near-tie note of ``tests/test_serve_chunked.py``), so there the
    agreement with the monolithic run is printed beside the CPU's own.
    Returns {cell: (same as the card's monolithic run, same as the CPU's
    chunked run, the CPU's chunked run same as its monolithic one, total,
    chunks dispatched)}."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("glm4-9b"),
                              dtype="float32", serve_quant=quant)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    params = {d: bridge.params_from_numpy(npp, d) for d in ("cuda", "cpu")}
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab, int(rng.integers(1, 30)))]).astype(np.int32)
        for _ in range(6)]

    def run(device, chunk, prefix):
        eng = LLMEngine(arch, params[device], EngineConfig(
            backend="paged", slots=4, max_len=64, admit_window=2, block_len=8,
            prefill_chunk_tokens=chunk, prefix_cache=prefix), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        return ([eng.request(h).output for h in hs],
                eng.metrics()["prefill_chunks_dispatched"])

    def agree(x, y):
        return sum(a == b for u, v in zip(x, y) for a, b in zip(u, v))

    cells = {}
    for prefix in (False, True):
        mono, _ = run("cuda", None, prefix)
        cpu_mono, _ = run("cpu", None, prefix)
        total = sum(len(x) for x in mono)
        for chunk in (8, 16):
            label = f"{chunk // 8} block{'s' if chunk > 8 else ''}, cache " \
                    f"{'on' if prefix else 'off'}"
            card, chunks = run("cuda", chunk, prefix)
            cpu, _ = run("cpu", chunk, prefix)
            same_m, same_c = agree(card, mono), agree(card, cpu)
            if chunks <= len(prompts):
                raise AssertionError(f"chunked prefill {label}: "
                                     f"{chunks:.0f} chunks")
            if same_c / total < 0.9 or (not quant and same_m / total < 0.9):
                raise AssertionError(
                    f"chunked prefill {label}: {same_m}/{total} tokens as "
                    f"monolithic, {same_c}/{total} as on the CPU")
            cells[label] = (same_m, same_c, agree(cpu, cpu_mono), total,
                            int(chunks))
    return cells


# ---------------------------------------------------------------------------
# Phase 4: the Mamba-2 family on the arena backend
# ---------------------------------------------------------------------------


def serve_arena(torch, arch, params, prompts, slots, max_new, max_len,
                embeds=None):
    """Full-width serving through ``LLMEngine(backend="arena")`` with the
    launch counts set to 0 just before and read just after."""
    from repro_torch.kernels.build import all_kernels
    from repro_torch.models.schema import leaves
    from repro_torch.serve import EngineConfig, LLMEngine

    eng = LLMEngine(arch, params, EngineConfig(
        backend="arena", slots=slots, max_len=max_len, admit_window=2,
        scheduler="bounded"))
    for k in all_kernels():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.add_request(p, max_new_tokens=max_new,
                               embeds=None if embeds is None else embeds[i])
               for i, p in enumerate(prompts)]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in all_kernels()}
    reqs = [eng.request(h) for h in handles]
    for r in reqs:
        if len(r.output) != max_new or r.finish_reason != "length":
            raise AssertionError(
                f"request {r.rid}: {len(r.output)} tokens, {r.finish_reason}")
    qkw = {} if eng.qparams is None else {"qparams": eng.qparams}
    logits, _ = arch.decode_step(params, eng.cache, eng.backend.last_tok,
                                 **qkw)
    if tuple(logits.shape) != (slots, arch.cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    m = eng.metrics()
    preemptions = sum(r.preemptions for r in reqs)
    return dict(cache=eng.cache, last_tok=eng.backend.last_tok, qkw=qkw,
        decode_dispatches=eng.backend.decode_dispatches,
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        decode_ms_per_iter_p50=m["iter_wall_p50_ms"],
        iterations=m["iterations"], wall_s=wall, preemptions=preemptions,
        prefills=len(reqs) + preemptions,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        state_bytes_per_slot=sum(
            v[:, :1].numel() * v.element_size()
            for v in leaves(eng.cache) if v.dim() > 1),
        launches=counts)


def profile_decode(torch, arch, params, cache, tokens, kernels=(), **kw):
    """One arena decode step (``kw`` passed on, e.g. ``qparams``): host wall
    (synchronized, unprofiled) and the device's kernel time from
    ``torch.profiler``, with the ops that take the most device time and the
    device time of the kernels named in ``kernels``. Device time 0 means
    the profiler saw no device activity (not measured)."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.decode_step(params, cache, tokens, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profiled(torch) as prof:
        arch.decode_step(params, cache, tokens, **kw)
    avgs = prof.key_averages()
    named = kernels
    # kernels are the device-side entries; each host op's self device time
    # is the time of the kernels it launched (the same kernels again)
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    ops = [e for e in avgs if not str(e.device_type).endswith("CUDA")]
    top = sorted(ops, key=dev_us, reverse=True)[:8]
    return dict(wall_ms=sorted(walls)[1],
                device_ms=sum(dev_us(e) for e in kernels) / 1e3,
                kernel_launches=sum(e.count for e in kernels),
                named_ms=sum(dev_us(e) for e in kernels
                             if any(n in e.key for n in named)) / 1e3,
                top={e.key: round(dev_us(e) / 1e3, 4) for e in top})


def profile_prefill(torch, arch, params, n_tokens, max_len, kernels,
                    same_outputs=False):
    """One admission prefill of an ``n_tokens`` prompt (batch 1, as the
    arena admits one): host wall (synchronized, unprofiled) and device
    time from ``torch.profiler``, split into the launches of the device
    kernels named in ``kernels`` (B8's or B9's) and the rest. With
    ``same_outputs`` the profiled pass's logits and cache must equal the
    unprofiled pass's bit for bit: every launch ran, whatever the profiler
    lists."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    toks = torch.randint(0, arch.cfg.vocab, (1, n_tokens), generator=gen,
                         device="cuda")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = arch.prefill(params, toks, max_len)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profiled(torch) as prof:
        got = arch.prefill(params, toks, max_len)
    if same_outputs and not bit_equal(got, want):
        raise AssertionError("the profiled prefill's logits or cache differ "
                             "from the unprofiled prefill's")
    on_dev = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    ours = [e for e in on_dev if any(k in e.key for k in kernels)]
    total = sum(dev_us(e) for e in on_dev) / 1e3
    ours_ms = sum(dev_us(e) for e in ours) / 1e3
    return dict(wall_ms=sorted(walls)[1], device_ms=total, kernel_ms=ours_ms,
                rest_ms=total - ours_ms,
                kernel_cuda_launches=sum(e.count for e in ours),
                kernel_launches=sum(e.count for e in on_dev))


def small_input_arena(torch, name, paged=False, quant=False):
    """``name``'s smoke config in float32 through the arena on the card
    (its kernel: B8 for mamba2-2.7b, B9 for recurrentgemma-9b) and on the
    CPU (plain versions): ≥ 90 % equal greedy tokens; on the card, the
    slot backend gives the arena's tokens. The dense and moe families run
    with ``paged`` (``serve_quant=False``: no hand-written kernel, and the
    port's paged backend on the card, float32 pools and B1, gives ≥ 90 % of
    the arena's tokens) or with ``quant`` (the int8 arena step: the dense
    families' W8A8 projections launch B3 seven times a layer and decode
    step, the moe family no kernel). Returns (card vs CPU, paged vs arena
    or None, total) equal greedy tokens."""
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import all_kernels
    from repro_torch.models import registry
    from repro_torch.models.transformer import LINEARS
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config(name), dtype="float32")
    if paged:
        cfg = dataclasses.replace(cfg, serve_quant=False)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40))
                            ).astype(np.int32) for _ in range(6)]
    outs = {}
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")) + ((("cuda", "paged"),)
                                                 if paged else ()):
        before = {k.name: k.launches for k in all_kernels()}
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
        launched = {k.name: k.launches - before[k.name]
                    for k in all_kernels()}
        want = {k: 0 for k in launched}
        if quant and eng.qparams is not None and device == "cuda":
            want["int8_gemm"] = (len(LINEARS) * cfg.n_layers
                                 * eng.backend.decode_dispatches)
        if (paged or quant) and backend != "paged" and launched != want:
            raise AssertionError(f"{name} {backend} on {device} launched "
                                 f"{launched}, want {want}")
    if outs["cuda", "slot"] != outs["cuda", "arena"]:
        raise AssertionError(f"on the card, slot vs arena greedy tokens "
                             f"differ: {outs}")

    def agree(x, y):
        return sum(a == b for u, v in zip(x, y) for a, b in zip(u, v))

    same = agree(outs["cuda", "arena"], outs["cpu", "arena"])
    total = sum(len(x) for x in outs["cpu", "arena"])
    if same / total < 0.9:
        raise AssertionError(f"{name} card vs CPU greedy tokens: "
                             f"{same}/{total} agree")
    if not paged:
        return same, None, total
    same_paged = agree(outs["cuda", "paged"], outs["cuda", "arena"])
    if same_paged / total < 0.9:
        raise AssertionError(f"{name} on the card, paged vs arena greedy "
                             f"tokens: {same_paged}/{total} agree")
    return same, same_paged, total


def counting_prefills(arch):
    """``arch`` whose ``prefill`` tallies the admissions by the length they
    prefill (the bucket where the arena pads a prompt, else the exact
    prompt), and the tally."""
    tally = {}

    def prefill(params, tokens, max_len, **kw):
        tally[tokens.shape[1]] = tally.get(tokens.shape[1], 0) + 1
        return arch.prefill(params, tokens, max_len, **kw)

    return dataclasses.replace(arch, prefill=prefill), tally


def qparams_bytes(qparams):
    """Bytes of a ``quantize_params`` tree: int8 weights and the int32
    bias, multiplier and shift vectors."""
    return sum(getattr(q, f).numel() * getattr(q, f).element_size()
               for layers in qparams.values() for layer in layers
               for q in layer.values()
               for f in ("w_q", "bias", "mult", "shift"))


def arena_run(torch, cfg, arch, params, prompts, slots, max_new, max_len,
              paged_step=None):
    """A dense or moe arch (bf16 weights and caches) served through
    ``LLMEngine(backend="arena")`` at full width by ``serve_arena``: every
    request's token count and finite logits, and the admissions by prefill
    length (for the dense family each a power-of-two bucket holding its
    prompt). With float caches (``serve_quant=False``) no hand-written
    kernel runs; under ``serve_quant`` (the int8 arena step) the dense
    family's W8A8 projections launch B3 exactly seven times a layer and
    decode step, prefill none, and nothing else runs a kernel. Then one
    profiled steady decode step (``profile_decode``, B3's share) beside
    the step's bytes bound: every weight read once (the embedding table
    only at ``slots`` rows; the projections as int8 ``qparams`` where the
    backend built them) and the K/V of each slot's valid positions.
    ``paged_step`` (``decode_steps``' result on bf16 pools in the same
    run) is printed beside it. Returns the run."""
    from repro_torch.models.transformer import LINEARS

    counted, tally = counting_prefills(arch)
    r = serve_arena(torch, counted, params, prompts, slots, max_new, max_len)
    want = {k: 0 for k in r["launches"]}
    quant = "qparams" in r["qkw"]
    if quant:
        want["int8_gemm"] = (len(LINEARS) * cfg.n_layers
                             * r["decode_dispatches"])
    if r["launches"] != want:
        raise AssertionError(f"{cfg.name} arena run launched {r['launches']}"
                             f", want {want} for {r['decode_dispatches']} "
                             f"decode steps")
    if sum(tally.values()) != r["prefills"]:
        raise AssertionError(f"{cfg.name}: {sum(tally.values())} prefills "
                             f"for {r['prefills']} admissions")
    # prompts of 64–512 tokens; a preempted request's re-prefill (prompt
    # and output) may take the next bucket
    if arch.supports_padded_prefill and any(
            n & (n - 1) or n < 64 or n > max_len for n in tally):
        raise AssertionError(f"{cfg.name}: prefill lengths {tally} are not "
                             f"power-of-two buckets of 64–{max_len}")
    kind = ("int8 arena step, bf16 caches holding int8 K/V"
            if arch.cfg.serve_quant else "bf16 caches")
    print(f"serve {cfg.name} arena ({kind}, {slots} slots, max_len "
          f"{max_len}): {len(prompts)} requests x {max_new} tokens "
          f"({r['prompt_tokens']} prompt tokens, longest "
          f"{max(len(p) for p in prompts)}), tokens/s="
          f"{r['tokens_per_s']:.2f} iter_ms(p50)="
          f"{r['decode_ms_per_iter_p50']:.2f} iterations="
          f"{r['iterations']:.0f} decode_steps={r['decode_dispatches']} "
          f"preemptions={r['preemptions']} "
          f"admissions by prefill length "
          f"({'bucket' if arch.supports_padded_prefill else 'exact'}): "
          f"{json.dumps(dict(sorted(tally.items())))} "
          f"cache_bytes={r['state_bytes_per_slot'] * slots} "
          f"kernels={json.dumps(r['launches'])}", flush=True)
    # the profiled step is profile_decode's fourth: row b attends its
    # len[b] + 4 valid positions
    kv_bytes = ((int(r["cache"]["len"].sum()) + 4 * slots)
                * r["state_bytes_per_slot"] // max_len)
    prof = profile_decode(torch, arch, params, r["cache"], r["last_tok"],
                          kernels=("int8_gemm",), **r["qkw"])
    w_ms, w_bytes = step_bound(params, slots)
    what = "weights read once"
    if quant:
        proj = sum(t.numel() * t.element_size()
                   for layers in (params["stacks"], params.get("tail", []))
                   for layer in layers for n, t in layer.items()
                   if n in LINEARS)
        w_bytes += qparams_bytes(r["qkw"]["qparams"]) - proj
        w_ms = w_bytes / HBM_BYTES_PER_S * 1e3
        what = "weights read once, the projections as int8"
    b_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    busy = (f"{prof['device_ms'] / prof['wall_ms']:.4f}" if prof["device_ms"]
            else "not measured")
    beside = ("" if paged_step is None else
              f"; the paged bf16 step of this run: device "
              f"{paged_step['device_ms']:.3f} ms in "
              f"{paged_step['kernels']:.0f} kernels, host p50 "
              f"{paged_step['step_ms_p50']:.2f} ms")
    print(f"{cfg.name} arena decode step ({kind}, {slots} slots): host wall "
          f"{prof['wall_ms']:.2f} ms, device kernel time "
          f"{prof['device_ms']:.3f} ms in {prof['kernel_launches']} kernels "
          f"(torch.profiler), int8_gemm {prof['named_ms']:.3f} ms of it, "
          f"device busy share {busy}; bytes bound "
          f"{b_ms:.3f} ms ({w_bytes / 1e9:.2f} GB of {what} and "
          f"{kv_bytes / 1e6:.1f} MB of valid K/V at 3.35 TB/s; weights alone "
          f"{w_ms:.3f} ms){beside}; device ms by op: "
          f"{json.dumps(prof['top'])}", flush=True)
    return r


def full_width_slot_agreement(cfg, arch, params, prompts, max_new,
                              max_len, embeds=None):
    """Two requests through ``slot`` and through a 2-slot arena at full
    width (exact-length prefill on both): the same greedy tokens. Returns
    the tokens compared and the launch counts of each run (set to 0 just
    before it)."""
    from repro_torch.kernels.build import all_kernels
    from repro_torch.serve import EngineConfig, LLMEngine

    outs, launches = {}, {}
    for backend in ("arena", "slot"):
        eng = LLMEngine(arch, params, EngineConfig(
            backend=backend, slots=2, max_len=max_len,
            prefill_buckets=False))
        for k in all_kernels():
            k.launches = 0
        hs = [eng.add_request(p, max_new_tokens=max_new,
                              embeds=None if embeds is None else embeds[i])
              for i, p in enumerate(prompts)]
        eng.run_until_drained()
        outs[backend] = [eng.request(h).output for h in hs]
        launches[backend] = {k.name: k.launches for k in all_kernels()}
    if outs["slot"] != outs["arena"]:
        raise AssertionError(f"{cfg.name} at full width, slot vs arena "
                             f"greedy tokens differ: {outs}")
    return sum(len(o) for o in outs["slot"]), launches


# ---------------------------------------------------------------------------
# Phase 6: the ITA integer path at full width
# ---------------------------------------------------------------------------


def ita_widths(cfg):
    """(name, layers, query heads, kv heads, S, D, causal, tile, paper
    network): the three networks the repo's Table II models
    (``src/repro/core/soc.py``), whose lengths need their own tiles, and a
    2048-token glm4-9b prompt."""
    return [("MobileBERT", 24, 4, 4, 128, 128, False, 128, True),
            ("Whisper-Tiny encoder", 4, 6, 6, 1500, 64, False, 125, True),
            ("DINOv2-S", 12, 6, 6, 1370, 64, False, 137, True),
            ("glm4-9b prompt", cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
             2048, cfg.hd, True, 128, False)]


def small_input_ita(torch):
    """On a small input the card's ``int8_attention`` (bf16 and f32, GQA,
    causal and not) and ``int_softmax`` equal the CPU's plain path bit for
    bit."""
    from repro_torch.kernels.int_softmax.ops import int_softmax
    from repro_torch.models.attention import int8_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n = 0
    for dtype, causal, s, blk in ((torch.bfloat16, True, 256, 64),
                                  (torch.float32, False, 250, 125)):
        q, k, v = (torch.randn((2, h, s, 64), generator=gen, device="cuda")
                   .to(dtype) for h in (4, 2, 2))
        kw = dict(causal=causal, block_q=blk, block_kv=blk)
        got = int8_attention(q, k, v, **kw).cpu()
        want = int8_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        if got.dtype != dtype or not torch.equal(got, want):
            raise AssertionError(f"int8_attention {dtype} causal={causal}: "
                                 f"card and CPU differ")
        n += got.numel()
    x = torch.randint(-127, 128, (3, 37, 129), generator=gen, device="cuda",
                      dtype=torch.int8)
    if not torch.equal(int_softmax(x, logit_scale=0.06).cpu(),
                       int_softmax(x.cpu(), logit_scale=0.06)):
        raise AssertionError("int_softmax: card and CPU differ")
    return n + x.numel()


def ita_path(torch, cfg):
    """Each width's network pass through the public entry points, its
    launch counts set to 0 just before and read just after; inputs are
    drawn beforehand (set-up, outside the timed pass)."""
    from repro_torch.kernels.build import all_kernels
    from repro_torch.kernels.int_softmax.ops import int_softmax
    from repro_torch.models.attention import LOGIT_AMAX, int8_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s_logit = LOGIT_AMAX / 127
    runs = []
    for name, layers, hq, hkv, s, d, causal, blk, paper in ita_widths(cfg):
        qkv = [[torch.randn((1, h, s, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for h in (hq, hkv, hkv)]
               for _ in range(layers)]
        logits = [torch.clamp(torch.round(
            torch.randn((hq * s, s), generator=gen, device="cuda") * 3.0
            / s_logit), -127, 127).to(torch.int8)
            for _ in range(layers if paper else 0)]
        for k in all_kernels():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [int8_attention(q, k, v, causal=causal, block_q=blk,
                               block_kv=blk) for q, k, v in qkv]
        torch.cuda.synchronize()
        attn_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        probs = [int_softmax(x, logit_scale=s_logit) for x in logits]
        torch.cuda.synchronize()
        smax_ms = (time.perf_counter() - t0) * 1e3
        counts = {k.name: k.launches for k in all_kernels()}
        for y, (q, _, _) in zip(outs, qkv):
            if y.shape != q.shape or y.dtype != torch.bfloat16 \
                    or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name}: int8_attention output "
                                     f"{tuple(y.shape)} {y.dtype} not finite")
        for p, x in zip(probs, logits):
            if p.shape != x.shape or p.dtype != torch.uint8:
                raise AssertionError(f"{name}: int_softmax output "
                                     f"{tuple(p.shape)} {p.dtype}")
        if counts["ita_attention"] != layers \
                or counts["int_softmax"] != len(logits):
            raise AssertionError(f"{name}: launches {counts} for {layers} "
                                 f"layers")
        # the attention pass again under torch.profiler (after the counts
        # are read): its device time, and B6's share of it; its outputs
        # equal the first pass's bit for bit (B6 is integer arithmetic), so
        # every launch ran, whatever the profiler lists
        with profiled(torch) as prof:
            again = [int8_attention(q, k, v, causal=causal, block_q=blk,
                                    block_kv=blk) for q, k, v in qkv]
        if not bit_equal(again, outs):
            raise AssertionError(f"{name}: the profiled pass's outputs "
                                 f"differ from the first pass's")
        on_dev = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        b6 = [e for e in on_dev if "ita_attention_kernel" in e.key]
        runs.append(dict(name=name, layers=layers, attn_ms=attn_ms,
                         device_ms=sum(dev_us(e) for e in on_dev) / 1e3,
                         b6_device_ms=sum(dev_us(e) for e in b6) / 1e3,
                         b6_launches=sum(e.count for e in b6),
                         smax_ms=smax_ms if paper else None,
                         shape=f"{hq}/{hkv} heads, S={s}, D={d}, "
                               f"{'causal' if causal else 'bidirectional'}, "
                               f"tiles {blk}",
                         launches=counts))
        del qkv, logits, outs, probs, again
    return runs


# ---------------------------------------------------------------------------
# Phase 7: gemma3-4b on the paged ring pools
# ---------------------------------------------------------------------------


def ring_prompts(vocab, seed):
    """12 prompts of 64–512 random tokens, 2 of 1000–1020 (their decodes
    cross the 1024-token window and the first ring rotation at position
    1040) and 2 of 3000–4000 (their rings wrap inside the prefill)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(64, 513)) for _ in range(12)]
    lens[2:2] = [int(rng.integers(1000, 1021))]
    lens[6:6] = [int(rng.integers(3000, 4001))]
    lens[9:9] = [int(rng.integers(1000, 1021))]
    lens[13:13] = [int(rng.integers(3000, 4001))]
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def small_input_ring_agreement(torch, quant):
    """Smoke-size gemma3-4b (window 16, float32) on ring pools (block_len
    4, max_len 64, prompts of 17–40 tokens: longer than the window)
    through the kernels on the card and the plain versions on the CPU:
    ≥ 90 % equal greedy tokens."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("gemma3-4b"),
                              dtype="float32", serve_quant=quant)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(17, 41))
                            ).astype(np.int32) for _ in range(6)]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend="paged", slots=4, max_len=64,
                                     admit_window=2, block_len=4),
                        device=device)
        if not eng.backend.ring:
            raise AssertionError("gemma3-4b-smoke at max_len 64: no ring")
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device] = [eng.request(h).output for h in hs]
    same = sum(a == b for x, y in zip(outs["cuda"], outs["cpu"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in outs["cpu"])
    if same / total < 0.9:
        raise AssertionError(f"ring pools, card vs CPU greedy tokens: "
                             f"{same}/{total} agree")
    return same, total


def serve_ring(torch, cfg, archs, params, prompts, slots, max_new, max_len,
               blk, spec_k):
    """``cfg`` served on its ring pools three times — int8 pools, bf16
    pools, and int8 pools with the prefix cache, chunked prefill and spec
    asked for — each through ``serve`` (launch counts set to 0 just before
    and read just after). Checks the pool bytes against the ring layout,
    one attention launch a layer and (int8) seven GEMMs a layer per decode
    step, and the opt-outs; returns the runs by label."""
    from repro_torch.models.cache import blocks_for, ring_blocks_for

    pattern, n_groups, tail = cfg.layer_layout()
    n_local = n_groups * pattern.count("L") + tail.count("L")
    n_layers = cfg.n_layers
    num_blocks = blocks_for(slots * max_len, blk) + 1
    ring_rows = 1 + slots * ring_blocks_for(cfg.local_window, blk)
    runs = {}
    for label, pool, kw in (
            ("int8", "int8", {}), ("bf16", "bf16", {}),
            ("int8 opt-outs", "int8",
             dict(prefix_cache=True, prefill_chunk_tokens=512,
                  spec_tokens=spec_k))):
        r = serve(torch, archs[pool], params, prompts, slots, max_new,
                  max_len=max_len, **kw)
        runs[label] = r
        row = pool_row_bytes(torch, cfg, blk, pool == "int8")
        want_bytes = ((n_layers - n_local) * num_blocks
                      + n_local * ring_rows) * row
        if r["pool_bytes"] != want_bytes:
            raise AssertionError(f"{cfg.name} {label}: pool_bytes "
                                 f"{r['pool_bytes']}, want {want_bytes}")
        print(f"serve {cfg.name} {label}: {len(prompts)} requests x {max_new} "
              f"tokens ({r['prompt_tokens']} prompt tokens, longest "
              f"{max(len(p) for p in prompts)}, window {cfg.local_window}), "
              f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iter_ms(p99)="
              f"{r['iter_ms_p99']:.2f} iter_ms(max)={r['iter_ms_max']:.2f} "
              f"ttft_avg_s={r['ttft_avg_s']:.4f} "
              f"iterations={r['iterations']:.0f} "
              f"decode_dispatches={r['decode_dispatches']:.0f} "
              f"preemptions={r['preemptions']} "
              f"prefill_chunks_dispatched={r['chunks']:.0f} "
              f"spec_drafted={r['spec_drafted']:.0f} "
              f"prefix_cache_hit_rate={r['prefix_cache_hit_rate']:.4f} "
              f"pool_bytes={r['pool_bytes']} (ring pools of {ring_rows} rows "
              f"for {n_local} L layers; full history at max_len {max_len}: "
              f"{n_layers * num_blocks * row}) "
              f"kernels={json.dumps(r['launches'])}", flush=True)
        attn = "paged_attention_int8" if pool == "int8" else "paged_attention"
        want = {attn: n_layers * r["decode_dispatches"],
                "int8_gemm": (7 * n_layers * r["decode_dispatches"]
                              if pool == "int8" else 0),
                "paged_attention_verify": 0,
                "paged_attention_verify_int8": 0}
        for k, n in want.items():
            if r["launches"][k] != n:
                raise AssertionError(
                    f"{cfg.name} {label}: {k} launched {r['launches'][k]} "
                    f"times, want {n} for {r['decode_dispatches']:.0f} "
                    f"decode steps")
    opt = runs["int8 opt-outs"]
    if opt["chunks"] != 0 or opt["spec_drafted"] != 0 \
            or opt["prefix_cache_hit_rate"] != 0 \
            or opt["prefix_hit_blocks"] != 0:
        raise AssertionError("the ring layout did not opt out of chunking, "
                             "spec or the prefix cache")
    if opt["outputs"] != runs["int8"]["outputs"]:
        raise AssertionError("the opt-out run's greedy tokens differ from "
                             "the plain int8 run's")
    return runs


# ---------------------------------------------------------------------------
# Phase 8: the moe family (qwen3-moe-30b-a3b) on the paged backend
# ---------------------------------------------------------------------------


def small_input_moe_agreement(torch, quant):
    """Smoke-size qwen3-moe-30b-a3b (8 experts top 2, float32, capacity
    1.25) through the kernels on the card and the plain versions on the
    CPU: equal greedy tokens; and on the card, ``spec_tokens=4`` with the
    prefix cache gives ``spec_tokens=0``'s greedy tokens. Returns (same
    card vs CPU, same spec on vs off, total)."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", serve_quant=quant)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 19)
    prompts = [np.concatenate([shared, np.tile(rng.integers(0, cfg.vocab, 3),
                                               8)[:int(rng.integers(4, 20))]])
               for _ in range(6)]
    outs = {}
    for device, k in (("cuda", 0), ("cpu", 0), ("cuda", 4)):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend="paged", slots=4, max_len=64,
                                     admit_window=2, block_len=8,
                                     spec_tokens=k,
                                     prefix_cache=True), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, k] = [eng.request(h).output for h in hs]

    def agree(x, y):
        return sum(a == b for u, v in zip(x, y) for a, b in zip(u, v))

    total = sum(len(x) for x in outs["cpu", 0])
    same_cpu = agree(outs["cuda", 0], outs["cpu", 0])
    same_spec = agree(outs["cuda", 4], outs["cuda", 0])
    if same_cpu != total or same_spec != total:
        raise AssertionError(
            f"qwen3-moe-30b-a3b-smoke ({'int8' if quant else 'float'} "
            f"pools): card vs CPU {same_cpu}/{total}, spec on vs off "
            f"{same_spec}/{total} greedy tokens agree")
    return same_cpu, same_spec, total


def step_bound(params, slots):
    """Bytes bound of one decode step's weights (ms, bytes): every weight
    but the embedding table read once (the moe family's expert products
    run over every expert's buffer), ``slots`` embedding rows; at the
    card's memory rate."""
    from repro_torch.models.schema import leaves

    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    emb = params["embed"]
    nbytes -= emb.numel() * emb.element_size()
    nbytes += slots * emb.shape[1] * emb.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def serve_moe(torch, cfg, archs, params, slots, max_new, spec_k):
    """``cfg`` served on the paged backend: random prompts on int8 and bf16
    pools, the shared-prefix workload on int8 pools with the prefix cache
    and spec off and on, and long prompts chunked by 512 on int8 pools,
    each through ``serve`` (launch counts set to 0 just before and read
    just after). A decode step launches the attention kernel once a layer
    (B2 on int8 pools, B1 on bf16), a verify step B5 once a layer, and the
    family never launches the int8 GEMM; returns the runs by label."""
    n = 16
    plain = random_prompts(cfg.vocab, n, seed=14)
    shared = shared_prefix_prompts(cfg.vocab, n, seed=15)
    long = long_prompts(cfg.vocab, seed=16)
    runs = {}
    for label, pool, prompts, kw in (
            ("int8", "int8", plain, {}),
            ("bf16", "bf16", plain, {}),
            ("int8 prefix", "int8", shared, dict(prefix_cache=True)),
            ("int8 spec+prefix", "int8", shared,
             dict(prefix_cache=True, spec_tokens=spec_k)),
            ("int8 long chunked", "int8", long,
             dict(max_len=4096 + max_new, prefill_chunk_tokens=512))):
        r = serve(torch, archs[pool], params, prompts, slots, max_new, **kw)
        runs[label] = r
        print(f"serve {cfg.name} {label}: {len(prompts)} requests x "
              f"{max_new} tokens ({r['prompt_tokens']} prompt tokens, "
              f"longest {max(len(p) for p in prompts)}), "
              f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iter_ms(p99)="
              f"{r['iter_ms_p99']:.2f} iter_ms(max)={r['iter_ms_max']:.2f} "
              f"ttft_avg_s={r['ttft_avg_s']:.4f} "
              f"iterations={r['iterations']:.0f} "
              f"decode_dispatches={r['decode_dispatches']:.0f} "
              f"preemptions={r['preemptions']} "
              f"prefill_chunks_dispatched={r['chunks']:.0f} "
              f"spec_accept_rate={r['spec_accept_rate']:.4f} "
              f"(drafted {r['spec_drafted']:.0f}, accepted "
              f"{r['spec_accepted']:.0f}) "
              f"prefix_cache_hit_rate={r['prefix_cache_hit_rate']:.4f} "
              f"pool_bytes={r['pool_bytes']} "
              f"kernels={json.dumps(r['launches'])}", flush=True)
        spec = "spec" in label
        steps = cfg.n_layers * r["decode_dispatches"]
        attn = ("paged_attention_verify_int8" if spec
                else "paged_attention_int8" if pool == "int8"
                else "paged_attention")
        want = {k: 0 for k in r["launches"]}
        want[attn] = steps
        for k, v in want.items():
            if r["launches"][k] != v:
                raise AssertionError(
                    f"{cfg.name} {label}: {k} launched {r['launches'][k]} "
                    f"times, want {v} for {r['decode_dispatches']:.0f} "
                    f"{'verify' if spec else 'decode'} steps")
    for label in ("int8 prefix", "int8 spec+prefix"):
        if runs[label]["prefix_cache_hit_rate"] <= 0:
            raise AssertionError(f"{cfg.name} {label}: no prefix-cache hit")
    if runs["int8 spec+prefix"]["spec_drafted"] <= 0:
        raise AssertionError(f"{cfg.name}: the spec run drafted nothing")
    if runs["int8 long chunked"]["chunks"] < 12:
        raise AssertionError(f"{cfg.name}: the long run dispatched "
                             f"{runs['int8 long chunked']['chunks']:.0f} "
                             f"chunks")
    return runs


def moe_phase(torch, qcfg, slots, max_new, spec_k):
    """Phase 8: the small-input checks, then full-width ``qcfg`` drawn on
    the card, served by ``serve_moe`` and its decode step profiled; frees
    the weights and returns the attention kernels' launches on the main
    path."""
    from repro_torch.models import registry, schema

    for pool, quant in (("float", False), ("int8", True)):
        same_c, same_s, total = small_input_moe_agreement(torch, quant)
        print(f"small input qwen3-moe-30b-a3b-smoke ({pool} pools, capacity "
              f"1.25): card vs CPU greedy tokens {same_c}/{total}; on the "
              f"card spec on vs off {same_s}/{total}", flush=True)
    qarch_f = registry.build(dataclasses.replace(qcfg, serve_quant=False))
    print(f"device memory before the draw: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qparams = schema.init_params(qarch_f.schema(), gen, "cuda",
                                 dtype=qcfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"qwen3-moe-30b-a3b params: "
          f"{schema.param_count(qarch_f.schema()) / 1e9:.3f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)",
          flush=True)
    qarchs = {"bf16": qarch_f, "int8": registry.build(qcfg)}
    qruns = serve_moe(torch, qcfg, qarchs, qparams, slots, max_new, spec_k)
    st = decode_steps(torch, qarchs["int8"], qparams, slots)
    b_ms, b_bytes = step_bound(qparams, slots)
    print(f"qwen3-moe-30b-a3b decode steps (int8 pools, {slots} slots "
          f"running 200-token prompts): step p50 {st['step_ms_p50']:.2f} ms "
          f"(host clock), device {st['device_ms']:.3f} ms a step of which "
          f"paged_attention_int8 {st['attn_device_ms']:.3f} ms and "
          f"int8_gemm {st['gemm_device_ms']:.3f} ms, {st['kernels']:.0f} "
          f"kernels a step (torch.profiler); device busy share "
          f"{st['device_ms'] / st['step_ms_p50']:.4f}; bytes bound "
          f"{b_ms:.3f} ms ({b_bytes / 1e9:.2f} GB of weights at 3.35 TB/s); "
          f"longest kernels (ms a step): {json.dumps(st['top'])}",
          flush=True)
    counts = {name: qruns[label]["launches"][name] for name, label in (
        ("paged_attention", "bf16"), ("paged_attention_int8", "int8"),
        ("paged_attention_verify_int8", "int8 spec+prefix"))}
    del qruns
    torch.cuda.empty_cache()
    # the float-cache arena (plain PyTorch, no hand-written kernel)
    same_c, same_p, total = small_input_arena(torch, "qwen3-moe-30b-a3b",
                                              paged=True)
    print(f"small input qwen3-moe-30b-a3b-smoke (float32, serve_quant off): "
          f"arena card vs CPU greedy tokens {same_c}/{total}; on the card "
          f"slot == arena, paged (float32 pools) vs arena {same_p}/{total}",
          flush=True)
    # 4 x 8 tokens: the int8 run below is the slice's; this one keeps the
    # float arena driven at full width inside the run's time budget
    r = arena_run(torch, qcfg, qarch_f, qparams,
                  random_prompts(qcfg.vocab, 4, seed=17), slots, 8, 1024)
    del r
    # the int8 arena step: float weights, int8 K/V, the ITA integer decode
    # attention in plain PyTorch (no hand-written kernel)
    same_c, _, total = small_input_arena(torch, "qwen3-moe-30b-a3b",
                                         quant=True)
    print(f"small input qwen3-moe-30b-a3b-smoke (float32, int8 arena step): "
          f"arena card vs CPU greedy tokens {same_c}/{total}; on the card "
          f"slot == arena", flush=True)
    r = arena_run(torch, qcfg, qarchs["int8"], qparams,
                  random_prompts(qcfg.vocab, 8, seed=17), slots, 16, 1024)
    del qparams, r
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 9: whisper-small (encdec) with embeds requests
# ---------------------------------------------------------------------------

# whisper-small's decoder rows for B1/B2/B4/B5 (phase 2): 8 rows up to its
# 448-token decoder envelope, on and beside the 16-key block edge
WHISPER_LENS = (0, 1, 15, 16, 17, 200, 447, 448)


def whisper_requests(cfg, n, seed, clips=None):
    """``n`` (decoder prompt, frame embeddings) pairs: embeddings [enc_seq,
    d_model] of 0.1 · standard normal from numpy ``seed``, one clip a
    request and prompts of 4–64 random tokens; or, with ``clips``, request
    i hears clip i % clips and its prompt is the clip's 32-token prefix
    (two blocks of 16) plus 4–32 tokens of its own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_clips = clips or n
    audio = [(0.1 * rng.standard_normal((cfg.enc_seq, cfg.d_model),
                                        dtype=np.float32))
             for _ in range(n_clips)]
    prefix = [rng.integers(0, cfg.vocab, 32) for _ in range(n_clips)]
    out = []
    for i in range(n):
        if clips:
            p = np.concatenate([prefix[i % clips], rng.integers(
                0, cfg.vocab, int(rng.integers(4, 33)))])
        else:
            p = rng.integers(0, cfg.vocab, int(rng.integers(4, 65)))
        out.append((p.astype(np.int32), audio[i % n_clips]))
    return out


def agree(x, y):
    """Equal greedy tokens of two runs' streams."""
    return sum(a == b for u, v in zip(x, y) for a, b in zip(u, v))


def small_input_encdec(torch):
    """whisper-small-smoke (float32; 24 frames a request, two clips) on the
    card and on the CPU: the paged backend over float32 and int8 pools
    (kernels B1/B2 on the card, their plain versions on the CPU), the
    arena float and under ``serve_quant`` (no kernel), and ``slot``: each
    card run ≥ 90 % of the CPU run's greedy tokens, slot == arena on the
    card, and the arena and slot runs launch no kernel. Returns {label:
    (card vs CPU or slot vs arena equal tokens, total)}."""
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import all_kernels
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    base = dataclasses.replace(configs.smoke_config("whisper-small"),
                               dtype="float32")
    rng = np.random.default_rng(1)
    audio = [(0.1 * rng.standard_normal((base.enc_seq, base.d_model))
              ).astype(np.float32) for _ in range(2)]
    prompts = [rng.integers(0, base.vocab, int(rng.integers(3, 30))
                            ).astype(np.int32) for _ in range(6)]
    npp = bridge.numpy_params(registry.build(base).schema(), seed=SEED)
    params = {d: bridge.params_from_numpy(npp, d) for d in ("cuda", "cpu")}
    out = {}
    for quant in (False, True):
        arch = registry.build(dataclasses.replace(base, serve_quant=quant))
        outs = {}
        for device, backend in (("cuda", "paged"), ("cpu", "paged"),
                                ("cuda", "arena"), ("cpu", "arena"),
                                ("cuda", "slot")):
            if backend == "slot" and quant:
                continue
            eng = LLMEngine(arch, params[device], EngineConfig(
                backend=backend, slots=4, max_len=64, admit_window=2,
                block_len=8), device=device)
            before = {k.name: k.launches for k in all_kernels()}
            hs = [eng.add_request(p, max_new_tokens=12, embeds=audio[i % 2])
                  for i, p in enumerate(prompts)]
            eng.run_until_drained()
            outs[device, backend] = [eng.request(h).output for h in hs]
            launched = {k.name: k.launches - before[k.name]
                        for k in all_kernels()}
            if backend != "paged" and any(launched.values()):
                raise AssertionError(f"whisper-small-smoke {backend} on "
                                     f"{device} launched {launched}")
        total = sum(len(x) for x in outs["cpu", "paged"])
        pool = "int8" if quant else "float32"
        out[f"paged {pool} pools"] = (agree(outs["cuda", "paged"],
                                            outs["cpu", "paged"]), total)
        out["arena " + ("int8 step" if quant else "float")] = (
            agree(outs["cuda", "arena"], outs["cpu", "arena"]), total)
        if not quant:
            out["slot == arena (card)"] = (agree(outs["cuda", "slot"],
                                                 outs["cuda", "arena"]),
                                           total)
    for label, (same, total) in out.items():
        if same / total < 0.9 or ("slot" in label and same != total):
            raise AssertionError(f"whisper-small-smoke {label}: {same}/"
                                 f"{total} greedy tokens agree")
    return out


def small_input_vlm_embeds(torch):
    """llava-next-34b-smoke (float32, ``serve_quant`` off) with ``embeds``
    requests (the prompt's embeddings beside placeholder tokens) on the
    arena, card against CPU (≥ 90 % equal greedy tokens), no kernel
    launched. Returns (equal, total)."""
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import all_kernels
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config("llava-next-34b"),
                              dtype="float32", serve_quant=False)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(2)
    reqs = []
    for _ in range(6):
        n = int(rng.integers(3, 30))
        reqs.append((rng.integers(0, cfg.vocab, n).astype(np.int32),
                     (0.5 * rng.standard_normal((n, cfg.d_model))
                      ).astype(np.float32)))
    outs = {}
    for device in ("cuda", "cpu"):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend="arena", slots=4, max_len=64,
                                     admit_window=2), device=device)
        before = {k.name: k.launches for k in all_kernels()}
        hs = [eng.add_request(p, max_new_tokens=12, embeds=e)
              for p, e in reqs]
        eng.run_until_drained()
        outs[device] = [eng.request(h).output for h in hs]
        if any(k.launches != before[k.name] for k in all_kernels()):
            raise AssertionError("the vlm arena run launched a kernel")
    same, total = agree(outs["cuda"], outs["cpu"]), sum(
        len(x) for x in outs["cpu"])
    if same / total < 0.9:
        raise AssertionError(f"llava-next-34b-smoke embeds on the arena: "
                             f"card vs CPU {same}/{total} tokens agree")
    return same, total


def clone_cache(cache):
    return {k: v.clone() for k, v in cache.items()}


def profiled_step_check(torch, step, cache, tokens, table, n_layers):
    """One paged step (``step``: an arch's decode or verify) over a copy
    of ``cache`` unprofiled and over another copy under ``profiled``: the
    logits and caches bit-equal, and the profiler lists the paged
    attention kernel exactly ``n_layers`` times. Returns (device ms of the
    step, of the attention kernel, kernels in the step)."""
    want = step(clone_cache(cache), tokens, table)
    torch.cuda.synchronize()
    c = clone_cache(cache)
    with profiled(torch) as prof:
        got = step(c, tokens, table)
    if not bit_equal(got, want):
        raise AssertionError("the profiled step's logits or cache differ "
                             "from the unprofiled step's")
    on_dev = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    attn = [e for e in on_dev if "paged_attention_kernel" in e.key]
    n_attn = sum(e.count for e in attn)
    if n_attn != n_layers:
        raise AssertionError(f"the profiled step ran the attention kernel "
                             f"{n_attn} times for {n_layers} layers")
    return (sum(dev_us(e) for e in on_dev) / 1e3,
            sum(dev_us(e) for e in attn) / 1e3,
            sum(e.count for e in on_dev))


def encdec_step_bound(params, cache, slots):
    """Bytes bound of one 8-slot paged decode step (ms, bytes): the
    decoder's weights, the final norm and the unembedding read once,
    ``slots`` embedding rows, every slot's cross K/V and the self K/V of
    the valid positions (and their block scales)."""
    from repro_torch.models.schema import leaves

    def nbytes(t):
        return t.numel() * t.element_size()

    w = (sum(nbytes(t) for t in leaves(params["dec_stack"]))
         + nbytes(params["final_norm"]) + nbytes(params["unembed"])
         + slots * params["embed"].shape[1] * params["embed"].element_size())
    kv = nbytes(cache["xk"]) + nbytes(cache["xv"])
    pool = cache["k"]
    per_pos = 2 * pool.shape[0] * pool.shape[2] * pool.shape[4] \
        * pool.element_size()
    kv += int(cache["len"].sum()) * per_pos
    return (w + kv) / HBM_BYTES_PER_S * 1e3, w, kv


def encdec_phase(torch, wcfg, slots, max_new, spec_k):
    """Phase 9: small inputs (whisper-small-smoke, llava-next-34b-smoke
    with embeds), then whisper-small at full width drawn on the card and
    served on the paged backend (int8 and bf16 pools: plain, spec 4 with
    the prefix cache on clip-shared prompts, chunked by 16), each decode
    or verify step launching B2/B1 or B5/B4 once a layer and nothing
    else; steady decode steps profiled (bit-equal to unprofiled ones); the
    arena float and int8 and slot == arena with no kernel. Frees the
    weights; returns the attention kernels' launches."""
    from repro_torch.models import registry, schema

    for label, (same, total) in small_input_encdec(torch).items():
        print(f"small input whisper-small-smoke (float32, 24 frames) "
              f"{label}: card vs CPU greedy tokens {same}/{total}"
              if "slot" not in label else
              f"small input whisper-small-smoke {label}: {same}/{total}",
              flush=True)
    same, total = small_input_vlm_embeds(torch)
    print(f"small input llava-next-34b-smoke (float32, embeds requests) on "
          f"the arena: card vs CPU greedy tokens {same}/{total}", flush=True)
    max_len = 448
    warch_f = registry.build(dataclasses.replace(wcfg, serve_quant=False))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wparams = schema.init_params(warch_f.schema(), gen, "cuda",
                                 dtype=wcfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"whisper-small params: "
          f"{schema.param_count(warch_f.schema()) / 1e9:.3f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)",
          flush=True)
    warchs = {"bf16": warch_f, "int8": registry.build(wcfg)}
    plain = whisper_requests(wcfg, 16, seed=18)
    shared = whisper_requests(wcfg, 16, seed=19, clips=4)
    runs = {}
    for pool in ("int8", "bf16"):
        for label, reqs, kw in (
                ("", plain, {}),
                (" spec+prefix", shared,
                 dict(prefix_cache=True, spec_tokens=spec_k)),
                (" chunked", plain[:8], dict(prefill_chunk_tokens=16))):
            # chunks rerun the encoder: the chunked runs serve 8 x 16
            new = max_new // 2 if "chunked" in label else max_new
            r = serve(torch, warchs[pool], wparams, [p for p, _ in reqs],
                      slots, new, max_len=max_len,
                      embeds=[e for _, e in reqs], **kw)
            runs[pool + label] = r
            spec = "spec" in label
            print(f"serve whisper-small {pool}{label}: {len(reqs)} requests "
                  f"x {new} tokens ({r['prompt_tokens']} decoder prompt "
                  f"tokens, {wcfg.enc_seq} frames each), tokens/s="
                  f"{r['tokens_per_s']:.2f} iter_ms(p50)="
                  f"{r['decode_ms_per_iter_p50']:.2f} iter_ms(max)="
                  f"{r['iter_ms_max']:.2f} ttft_avg_s={r['ttft_avg_s']:.4f} "
                  f"iterations={r['iterations']:.0f} decode_dispatches="
                  f"{r['decode_dispatches']:.0f} preemptions="
                  f"{r['preemptions']} prefill_chunks_dispatched="
                  f"{r['chunks']:.0f} spec_accept_rate="
                  f"{r['spec_accept_rate']:.4f} prefix_cache_hit_rate="
                  f"{r['prefix_cache_hit_rate']:.4f} pool_bytes="
                  f"{r['pool_bytes']} kernels={json.dumps(r['launches'])}",
                  flush=True)
            attn = ("paged_attention_verify" if spec else "paged_attention"
                    ) + ("_int8" if pool == "int8" else "")
            want = {k: 0 for k in r["launches"]}
            want[attn] = wcfg.n_layers * r["decode_dispatches"]
            if r["launches"] != want:
                raise AssertionError(
                    f"whisper-small {pool}{label} launched {r['launches']}, "
                    f"want {want} for {r['decode_dispatches']:.0f} "
                    f"{'verify' if spec else 'decode'} steps")
        if runs[pool + " spec+prefix"]["prefix_cache_hit_rate"] <= 0:
            raise AssertionError(f"whisper-small {pool} spec+prefix: no "
                                 f"prefix-cache hit")
        if runs[pool + " chunked"]["chunks"] <= 8:
            raise AssertionError(f"whisper-small {pool} chunked: "
                                 f"{runs[pool + ' chunked']['chunks']:.0f} "
                                 f"chunks")
    counts = {
        "paged_attention_int8": runs["int8"]["launches"][
            "paged_attention_int8"] + runs["int8 chunked"]["launches"][
            "paged_attention_int8"],
        "paged_attention": runs["bf16"]["launches"]["paged_attention"]
        + runs["bf16 chunked"]["launches"]["paged_attention"],
        "paged_attention_verify_int8": runs["int8 spec+prefix"]["launches"][
            "paged_attention_verify_int8"],
        "paged_attention_verify": runs["bf16 spec+prefix"]["launches"][
            "paged_attention_verify"]}
    del runs
    # steady 8-slot decode steps (64-token prompts), then one decode and
    # one verify step profiled beside unprofiled copies
    for pool in ("int8", "bf16"):
        arch = warchs[pool]
        st = decode_steps(torch, arch, wparams, slots, prompt_len=64,
                          max_len=max_len, embeds=plain[0][1],
                          keep_engine=True)
        eng = st["engine"]
        b_ms, w_bytes, kv_bytes = encdec_step_bound(wparams, eng.cache,
                                                    slots)
        table = eng.backend._tables()
        tok = eng.backend.last_tok
        dec = profiled_step_check(
            torch, lambda c, t, tb: arch.paged_decode_step(wparams, c, t, tb),
            eng.cache, tok, table, wcfg.n_layers)
        ver = profiled_step_check(
            torch, lambda c, t, tb: arch.paged_verify_step(wparams, c, t, tb),
            eng.cache, tok[:, None].repeat(1, spec_k + 1).contiguous(),
            table, wcfg.n_layers)
        print(f"whisper-small decode steps ({pool} pools, {slots} slots "
              f"running 64-token prompts): step p50 {st['step_ms_p50']:.2f} "
              f"ms (host clock), device {st['device_ms']:.3f} ms a step of "
              f"which paged attention {st['attn_device_ms']:.3f} ms, "
              f"{st['kernels']:.0f} kernels a step (torch.profiler); device "
              f"busy share {st['device_ms'] / st['step_ms_p50']:.4f}; bytes "
              f"bound {b_ms:.4f} ms ({w_bytes / 1e6:.1f} MB of decoder "
              f"weights and unembedding, {kv_bytes / 1e6:.1f} MB of cross "
              f"and valid self K/V at 3.35 TB/s); a profiled decode step "
              f"bit-equal to an unprofiled one: device {dec[0]:.3f} ms, "
              f"attention {dec[1]:.4f} ms in {wcfg.n_layers} launches, "
              f"{dec[2]} kernels; a profiled verify step (Q={spec_k + 1}): "
              f"device {ver[0]:.3f} ms, attention {ver[1]:.4f} ms in "
              f"{wcfg.n_layers} launches, {ver[2]} kernels; longest kernels "
              f"(ms a step): {json.dumps(st['top'])}", flush=True)
        del st, eng
    # the arena (float caches, then the int8 step; 8 x 16 tokens) and
    # slot: no kernel
    for label, arch in (("float", warchs["bf16"]), ("int8", warchs["int8"])):
        r = serve_arena(torch, arch, wparams, [p for p, _ in plain[:8]],
                        slots, max_new // 2, max_len,
                        embeds=[e for _, e in plain[:8]])
        if any(r["launches"].values()):
            raise AssertionError(f"whisper-small arena {label} launched "
                                 f"{r['launches']}")
        print(f"serve whisper-small arena ({label}, bf16 caches, {slots} "
              f"slots, max_len {max_len}): 8 requests x {max_new // 2} "
              f"tokens, "
              f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iterations="
              f"{r['iterations']:.0f} preemptions={r['preemptions']} "
              f"cache_bytes={r['state_bytes_per_slot'] * slots} "
              f"kernels={json.dumps(r['launches'])}", flush=True)
        del r
        n, launched = full_width_slot_agreement(
            wcfg, arch, wparams, [p for p, _ in plain[:2]], 8, max_len,
            embeds=[e for _, e in plain[:2]])
        if any(v for run in launched.values() for v in run.values()):
            raise AssertionError(f"whisper-small slot/arena {label} launched "
                                 f"{launched}")
        print(f"whisper-small {label} at full width: slot == arena (2 slots)"
              f", {n} greedy tokens", flush=True)
    del wparams
    torch.cuda.empty_cache()
    return counts


def pool_row_bytes(torch, cfg, blk, int8):
    """Bytes of one pool row of one layer: K and V blocks, and the two
    per-block scales on int8 pools."""
    esz = 1 if int8 else torch.empty((), dtype=cfg.compute_dtype
                                     ).element_size()
    return 2 * cfg.n_kv_heads * blk * cfg.hd * esz + (8 if int8 else 0)


# the kernel whose library builds last; checked at the start of phase 6
LAST_BUILT = "ita_attention"


def print_build(logs, t0) -> None:
    print(f"built {len(logs)} kernel librar{'ies' if len(logs) > 1 else 'y'}"
          f" {time.perf_counter() - t0:.1f} s after the builds started",
          flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {Path(src).name}: {line.strip()}")


def print_entry(e) -> None:
    lib = "null" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
    print(f"kernel {e['name']}: kernel_ms={e['ms']:.4f} "
          f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
          f"({e['bound_by']}) library_ms={lib} "
          f"max_abs_err={e['max_abs_err']} [{e['shape']}]", flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible; this script runs on the card")
    try:
        from repro_torch import configs
        from repro_torch.kernels.build import (
            all_kernels, finish_builds, start_builds,
        )
        from repro_torch.models import registry, schema
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card and the build ------------------------------------
    phase(1, "the card and the build")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    # every nvcc starts now; B6's, the longest build by minutes and needed
    # only in phase 6, finishes while phases 2-5 run
    pending = start_builds()
    print_build(finish_builds(pending, [k.name for k in all_kernels()
                                        if k.name != LAST_BUILT]), t0)

    # -- phase 2: kernels vs plain versions ---------------------------------
    phase(2, "kernels vs plain versions")
    cfg = configs.get_config("glm4-9b")
    slots, blk, max_new, spec_k = 8, 16, 32, 4
    lens = [0, 1, 17, 64, 130, 255, 400, 544]
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_

    def read_flush():   # evicts L2 and leaves it clean
        scratch.view(torch.float32).sum()

    mcfg = configs.get_config("mamba2-2.7b")
    rcfg = configs.get_config("recurrentgemma-9b")
    entries = [check_int8_gemm(torch, cfg, slots, slots * (spec_k + 1),
                               read_flush),
               check_attention(torch, cfg, slots, blk, lens, flush,
                               int8=False),
               check_attention(torch, cfg, slots, blk, lens, flush,
                               int8=True),
               check_verify(torch, cfg, slots, blk, lens, spec_k + 1, flush,
                            int8=False),
               check_verify(torch, cfg, slots, blk, lens, spec_k + 1, flush,
                            int8=True),
               check_ssd_scan(torch, mcfg, [1, 5, 129, 512, 2048], 512),
               check_rglru(torch, rcfg,
                           [1, 5, 255, 256, 257, 512, 2048, 2300], 512),
               check_int_softmax(torch, cfg, flush, read_flush)]
    gcfg = configs.get_config("gemma3-4b")
    g_max_len = 4096 + max_new
    g_attn = [check_ring_attention(torch, gcfg, blk, g_max_len, flush,
                                   int8=i8) for i8 in (False, True)]
    g_gemm = check_int8_gemm_shapes(torch, gcfg, (1, slots), read_flush)
    qcfg = configs.get_config("qwen3-moe-30b-a3b")
    q_attn = [check(torch, qcfg, slots, blk, MOE_LENS, *extra, flush,
                    int8=i8)
              for check, extra in ((check_attention, ()),
                                   (check_verify, (spec_k + 1,)))
              for i8 in (False, True)]
    wcfg = configs.get_config("whisper-small")
    w_attn = [check(torch, wcfg, slots, blk, WHISPER_LENS, *extra, flush,
                    int8=i8)
              for check, extra in ((check_attention, ()),
                                   (check_verify, (spec_k + 1,)))
              for i8 in (False, True)]
    i8_attn = check_int8_decode_attention(torch, cfg, gcfg, slots, flush)
    del scratch
    for e in entries:
        print_entry(e)
    ssd, lru, smax = entries[-3:]

    def opt_ms(v):
        return "not measured" if v is None else f"{v:.4f}"

    def r5(v):
        return None if v is None else round(v, 5)

    print(f"kernel ssd_scan max |err| per case: {json.dumps(ssd['errs'])}",
          flush=True)
    print(f"kernel ssd_scan at S={ssd['main_len']}: "
          f"device_ms={opt_ms(ssd['device_ms'])} "
          f"({ssd['device_ops']:g} device ops a call, torch.profiler) "
          f"event_ms={ssd['ms']:.4f}; {ssd['launches_per_call']} CUDA "
          f"launches a call, blocks (local, chain, output) "
          f"{list(ssd['grids'])} for 132 SMs; bound {ssd['bound_ms']:.4f} ms "
          f"(split TF32: 3 x flops at 495 TF/s), f32 CUDA-core bound "
          f"{ssd['bound_f32_ms']:.4f} ms; device ms by kernel "
          f"{json.dumps({k: round(v, 4) for k, v in ssd['by_kernel'].items()})}",
          flush=True)
    print("kernel ssd_scan per S (with state; event ms, device ms, CUDA "
          "launches, blocks): " + json.dumps(
              {s: [round(v["ms"], 4), opt_ms(v["device_ms"]),
                   v["launches"], list(v["grids"])]
               for s, v in ssd["per_len"].items()}), flush=True)
    print(f"kernel rglru max |err| per case: {json.dumps(lru['errs'])}",
          flush=True)
    print("kernel rglru per S (B=1, D=4096, bf16; event ms, device ms "
          "(torch.profiler), bytes bound ms, blocks of 16 channels for 132 "
          "SMs, 64-row tiles): " + json.dumps(
              {s: [round(v["ms"], 4), opt_ms(v["device_ms"]),
                   round(v["bound_ms"], 4), v["blocks"], v["tiles"]]
               for s, v in lru["per_len"].items()}), flush=True)
    print(f"kernel int_softmax: {smax['cases_checked']} cases bit-exact; "
          f"bound {smax['bound_ms']:.4f} ms ({smax['bound_by']}) at "
          f"{B7_OPS} int32 operations an element ({smax['bound_17_ms']:.4f} "
          f"ms at the first body's {B7_OPS_FIRST})", flush=True)
    print("kernel int_softmax per phase-6 width (event ms and device ms "
          "(torch.profiler) with L2 flushed by a write, device ms with L2 "
          "flushed by a read; Tensor.copy_ of the same bytes: device ms "
          "after each flush; bytes bound ms, bound ms at "
          f"{B7_OPS} and at {B7_OPS_FIRST} int32 operations an element; "
          "plan): " + json.dumps(
              {k: [round(v["ms"], 4)] + [r5(v[t]) for t in (
                  "device_ms", "device_ms_read", "copy_ms", "copy_ms_read")]
               + [round(v[t], 5) for t in ("bound_bytes_ms", "bound_ops_ms",
                                           "bound_17_ms")] + [v["plan"]]
               for k, v in smax["per_width"].items()}), flush=True)
    gemm = entries[0]
    print(f"kernel int8_gemm at the verify pass's M={gemm['verify_rows']}: "
          f"kernel_ms={gemm['verify_ms']:.4f} "
          f"bound_ms={gemm['verify_bound_ms']:.4f}", flush=True)

    print(f"kernel int8_gemm per layer (torch.profiler device time, L2 "
          f"flushed by a read before each layer): M={slots} "
          f"{opt_ms(gemm['device_ms'])} ms ({gemm['device_ops']:g} device "
          f"ops), M={gemm['verify_rows']} {opt_ms(gemm['verify_device_ms'])} "
          f"ms; {gemm['cases_checked']} cases bit-exact; torch._int_mm "
          f"alone (the product only, M=32, 7 projections): "
          f"{gemm['library_mm_ms']:.4f} ms", flush=True)
    print(f"kernel int8_gemm at M=1 (the slot backend's int8 decode; 7 "
          f"projections of one layer, L2 flushed by a read before each "
          f"layer): kernel_ms={gemm['m1_ms']:.4f} device_ms="
          f"{opt_ms(gemm['m1_device_ms'])} bound_ms={gemm['m1_bound_ms']:.4f}"
          f" ({gemm['m1_bound_by']}); torch._int_mm alone at M=32 (M=1 "
          f"padded): {gemm['m1_library_mm_ms']:.4f} ms", flush=True)
    print("kernel int8_gemm per projection (event ms with L2 flushed by a "
          "read before each call, bound ms, blocks): " + json.dumps(
              {k: [round(t, 4), round(b, 4), grid]
               for k, (t, b, grid) in gemm["per_proj"].items()}), flush=True)
    for e in entries[1:5]:
        ctas = e["grid"][0] * e["grid"][1] * e["grid"][2]
        dev = ("not measured" if e["device_ms"] is None
               else f"{e['device_ms']:.4f}")
        lib = ("not measured" if e["library_device_ms"] is None
               else f"{e['library_device_ms']:.4f}")
        print(f"kernel {e['name']}: device_ms={dev} "
              f"({e['device_ops']:g} device ops a call) "
              f"library_device_ms={lib} ({e['library_device_ops']:g}) "
              f"(torch.profiler); grid {tuple(e['grid'])} = {ctas} blocks "
              f"for 132 SMs; {e['cases_checked']} cases checked",
              flush=True)
    print(f"decode_attention_int8 (the int8 arena's attention, plain "
          f"PyTorch, float64 products): card == CPU bit for bit in "
          f"{i8_attn['cases_checked']} cases (glm4-9b bf16 and f32, {slots} "
          f"rows, lens 1-1024, a row of equal logits; gemma3-4b bf16 ring "
          f"rows wrapped to 3000); at glm4-9b bf16 event ms "
          f"{i8_attn['ms']:.4f} (L2 flushed), CPU ms {i8_attn['cpu_ms']:.2f}, "
          f"bytes bound {i8_attn['bound_ms']:.5f} ms", flush=True)
    print("verify kernels at Q=1 and in row 0: bit-equal to decode (serving "
          "lens and split-boundary lens)", flush=True)
    for e in g_attn:
        print(f"kernel {e['name']} at gemma3-4b's geometry (Hq={gcfg.n_heads} "
              f"Hkv={gcfg.n_kv_heads} D={gcfg.hd} blk={blk}, window "
              f"{gcfg.local_window}; ring rows: 65 entries, start = first·16 "
              f"for first in {list(RING_FIRSTS)}, lens-start "
              f"{list(RING_RELS)}; full rows: {-(-g_max_len // blk)} "
              f"entries, lens {list(FULL_LENS)}): {e['cases_checked']} cases "
              f"allclose, max |err| {json.dumps(e['errs'])}", flush=True)
        for label, t in e["timing"].items():
            print(f"kernel {e['name']} gemma3-4b {label} ({t['rows']}): "
                  f"kernel_ms={t['ms']:.4f} device_ms={opt_ms(t['device_ms'])}"
                  f" plain_ms={t['plain_ms']:.4f} library_ms="
                  f"{t['library_ms']:.4f} bound_ms={t['bound_ms']:.5f} "
                  f"({t['bound_by']}) grid {t['grid']}", flush=True)
    print(f"kernel int8_gemm at gemma3-4b's projections "
          f"{json.dumps(g_gemm['shapes'])} (K, N): {g_gemm['cases_checked']} "
          f"cases bit-exact at M=1 and M={slots}; one layer at "
          f"M={g_gemm['m']}: kernel_ms={g_gemm['ms']:.4f} device_ms="
          f"{opt_ms(g_gemm['device_ms'])} bound_ms={g_gemm['bound_ms']:.4f} "
          f"({g_gemm['bound_by']})", flush=True)

    for e, model in [(e, qcfg) for e in q_attn] + [(e, wcfg) for e in w_attn]:
        print(f"kernel {e['name']} at {model.name}'s geometry (a GQA "
              f"group of {model.n_heads // model.n_kv_heads}; {e['shape']}): "
              f"{e['cases_checked']} cases allclose, max |err| "
              f"{e['max_abs_err']}; kernel_ms={e['ms']:.4f} device_ms="
              f"{opt_ms(e['device_ms'])} plain_ms={e['plain_ms']:.4f} "
              f"library_ms={e['library_ms']:.4f} library_device_ms="
              f"{opt_ms(e['library_device_ms'])} bound_ms="
              f"{e['bound_ms']:.5f} ({e['bound_by']}) grid "
              f"{tuple(e['grid'])}", flush=True)

    # -- phase 3: full-width glm4-9b through LLMEngine ----------------------
    phase(3, "glm4-9b on the paged backend")
    same_f, total_f = small_input_agreement(torch, quant=False)
    same_q, total_q = small_input_agreement(torch, quant=True)
    print(f"small input, card vs CPU greedy tokens: float {same_f}/{total_f}, "
          f"int8 {same_q}/{total_q}", flush=True)
    same_f, total_f = small_input_spec_agreement(torch, quant=False)
    same_q, total_q = small_input_spec_agreement(torch, quant=True)
    print(f"small input on the card, spec on vs off greedy tokens: float "
          f"{same_f}/{total_f}, int8 {same_q}/{total_q}", flush=True)
    for pool, quant in (("float", False), ("int8", True)):
        cells = small_input_chunked_agreement(torch, quant)
        print(f"small input on the card, {pool} pools, chunked prefill "
              f"(greedy tokens equal to the card's monolithic run / to the "
              f"CPU's chunked run / the CPU's chunked run to its monolithic "
              f"one, of all; chunks dispatched): "
              + "; ".join(f"{k} {m}/{c}/{cm}/{t}, {n} chunks"
                          for k, (m, c, cm, t, n) in cells.items()),
              flush=True)
    arch_f = registry.build(dataclasses.replace(cfg, serve_quant=False))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = schema.init_params(arch_f.schema(), gen, "cuda",
                                dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"glm4-9b params: {schema.param_count(arch_f.schema()) / 1e9:.2f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)", flush=True)
    n_requests = 16
    archs = {"float": arch_f, "int8": registry.build(cfg)}
    plain = random_prompts(cfg.vocab, n_requests, seed=2)
    shared = shared_prefix_prompts(cfg.vocab, n_requests, seed=4)
    long = long_prompts(cfg.vocab, seed=10)
    long_kw = dict(max_len=4096 + max_new)
    runs = {}
    for label, pool, prompts, kw in (
            ("float", "float", plain, {}),
            ("int8", "int8", plain, {}),
            ("float prefix", "float", shared, dict(prefix_cache=True)),
            ("float spec+prefix", "float", shared,
             dict(prefix_cache=True, spec_tokens=spec_k)),
            ("int8 prefix", "int8", shared, dict(prefix_cache=True)),
            ("int8 spec+prefix", "int8", shared,
             dict(prefix_cache=True, spec_tokens=spec_k)),
            ("int8 long chunked", "int8", long,
             dict(long_kw, prefill_chunk_tokens=512)),
            ("float long chunked", "float", long,
             dict(long_kw, prefill_chunk_tokens=512)),
            ("int8 long", "int8", long, long_kw),
            ("int8 chunked+prefix", "int8", shared,
             dict(prefix_cache=True, prefill_chunk_tokens=128))):
        r = serve(torch, archs[pool], params, prompts, slots, max_new, **kw)
        runs[label] = r
        print(f"serve {label}: {n_requests} requests x {max_new} tokens "
              f"({r['prompt_tokens']} prompt tokens, longest "
              f"{max(len(p) for p in prompts)}), "
              f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iter_ms(p99)="
              f"{r['iter_ms_p99']:.2f} iter_ms(max)={r['iter_ms_max']:.2f} "
              f"decode_iter_jitter_ms={r['jitter_ms']:.2f} "
              f"ttft_avg_s={r['ttft_avg_s']:.4f} "
              f"iterations={r['iterations']:.0f} "
              f"prefill_chunks_dispatched={r['chunks']:.0f} "
              f"prefill_chunk_stalls={r['stalls']:.0f} "
              f"preemptions={r['preemptions']} "
              f"spec_accept_rate={r['spec_accept_rate']:.4f} "
              f"(drafted {r['spec_drafted']:.0f}, accepted {r['spec_accepted']:.0f}) "
              f"prefix_cache_hit_rate={r['prefix_cache_hit_rate']:.4f} "
              f"prefill_skip_rate={r['prefill_skip_rate']:.4f} "
              f"kernels={json.dumps(r['launches'])}", flush=True)
    need = {"float": ["paged_attention"],
            "int8": ["paged_attention_int8", "int8_gemm"],
            "float spec+prefix": ["paged_attention_verify"],
            "int8 spec+prefix": ["paged_attention_verify_int8", "int8_gemm"],
            "int8 long chunked": ["paged_attention_int8", "int8_gemm"],
            "float long chunked": ["paged_attention"],
            "int8 long": ["paged_attention_int8", "int8_gemm"],
            "int8 chunked+prefix": ["paged_attention_int8", "int8_gemm"]}
    for label, names in need.items():
        for k in names:
            if runs[label]["launches"][k] == 0:
                raise AssertionError(f"{label} run never launched {k}")
    if runs["float"]["preemptions"] + runs["int8"]["preemptions"] == 0:
        raise AssertionError("no preemption happened")
    for label in ("float prefix", "int8 prefix", "float spec+prefix",
                  "int8 spec+prefix", "int8 chunked+prefix"):
        if runs[label]["prefix_cache_hit_rate"] <= 0:
            raise AssertionError(f"{label} run had no prefix-cache hit")
    # each long prompt takes at least 6 chunks of 512 tokens
    for label in ("int8 long chunked", "float long chunked"):
        if runs[label]["chunks"] < 12:
            raise AssertionError(f"{label} run dispatched "
                                 f"{runs[label]['chunks']:.0f} chunks")
    if runs["int8 long"]["chunks"] != 0:
        raise AssertionError("the monolithic long run dispatched chunks")
    main_counts = {"paged_attention": runs["float"]["launches"]["paged_attention"],
                   "paged_attention_int8":
                       runs["int8"]["launches"]["paged_attention_int8"],
                   "int8_gemm": runs["int8"]["launches"]["int8_gemm"],
                   "paged_attention_verify":
                       runs["float spec+prefix"]["launches"][
                           "paged_attention_verify"],
                   "paged_attention_verify_int8":
                       runs["int8 spec+prefix"]["launches"][
                           "paged_attention_verify_int8"]}
    for pool in ("int8", "float"):
        st = decode_steps(torch, archs[pool], params, slots)
        print(f"decode steps ({pool} pools, {slots} slots running 200-token "
              f"prompts): step p50 {st['step_ms_p50']:.2f} ms (host clock), "
              f"device {st['device_ms']:.3f} ms a step of which int8_gemm "
              f"{st['gemm_device_ms']:.3f} ms, {st['kernels']:.0f} kernels a "
              f"step (torch.profiler)", flush=True)
    # the float-cache arena and slot backends (plain PyTorch, no kernel)
    for name in ("glm4-9b", "gemma3-4b"):
        same_c, same_p, total = small_input_arena(torch, name, paged=True)
        print(f"small input {name}-smoke (float32, serve_quant off): arena "
              f"card vs CPU greedy tokens {same_c}/{total}; on the card slot "
              f"== arena, paged (float32 pools) vs arena {same_p}/{total}",
              flush=True)
    # 8 x 16 tokens, which keeps the whole run near 650 s
    r = arena_run(torch, cfg, arch_f, params, plain[:8], slots, 16, 1024,
                  paged_step=st)
    n, _ = full_width_slot_agreement(cfg, arch_f, params, plain[:2], 8, 1024)
    print(f"glm4-9b at full width: slot == arena (2 slots, exact prefill), "
          f"{n} greedy tokens", flush=True)
    del r
    # the int8 arena step (serve_quant: W8A8 projections through B3, int8
    # K/V in the bf16 caches, the ITA integer decode attention)
    for name in ("glm4-9b", "gemma3-4b", "llava-next-34b"):
        same_c, _, total = small_input_arena(torch, name, quant=True)
        print(f"small input {name}-smoke (float32, int8 arena step): arena "
              f"card vs CPU greedy tokens {same_c}/{total}; on the card slot "
              f"== arena", flush=True)
    r = arena_run(torch, cfg, archs["int8"], params, plain[:8], slots, 16,
                  1024)
    main_counts["int8_gemm"] += r["launches"]["int8_gemm"]
    del r
    n, launched = full_width_slot_agreement(cfg, archs["int8"], params,
                                            plain[:2], 8, 1024)
    if launched["slot"]["int8_gemm"] == 0:
        raise AssertionError("the int8 slot run never launched int8_gemm")
    main_counts["int8_gemm"] += launched["slot"]["int8_gemm"]
    print(f"glm4-9b int8 arena step at full width: slot == arena (2 slots, "
          f"exact prefill), {n} greedy tokens; int8_gemm launched "
          f"{launched['slot']['int8_gemm']} times by slot (M = 1), "
          f"{launched['arena']['int8_gemm']} by arena (M = 2)", flush=True)
    del params
    torch.cuda.empty_cache()

    # -- phase 4: full-width mamba2-2.7b through LLMEngine(backend="arena") -
    phase(4, "mamba2-2.7b on the arena")
    same_m, _, total_m = small_input_arena(torch, "mamba2-2.7b")
    print(f"small input mamba2-2.7b-smoke: card vs CPU greedy tokens "
          f"{same_m}/{total_m}; on the card slot == arena", flush=True)
    march = registry.build(mcfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mparams = schema.init_params(march.schema(), gen, "cuda",
                                 dtype=mcfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"mamba2-2.7b params: "
          f"{schema.param_count(march.schema()) / 1e9:.2f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)", flush=True)
    r = serve_arena(torch, march, mparams,
                    random_prompts(mcfg.vocab, n_requests, seed=6), slots,
                    max_new, 512 + max_new)
    print(f"serve mamba2-2.7b arena: {n_requests} requests x {max_new} tokens "
          f"({r['prompt_tokens']} prompt tokens), "
          f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
          f"{r['decode_ms_per_iter_p50']:.2f} iterations={r['iterations']:.0f} "
          f"preemptions={r['preemptions']} prefills={r['prefills']} "
          f"state_bytes_per_slot={r['state_bytes_per_slot']} "
          f"kernels={json.dumps(r['launches'])}", flush=True)
    if r["launches"]["ssd_scan"] != mcfg.n_layers * r["prefills"]:
        raise AssertionError(
            f"ssd_scan launched {r['launches']['ssd_scan']} times for "
            f"{r['prefills']} admission prefills of {mcfg.n_layers} layers")
    main_counts["ssd_scan"] = r["launches"]["ssd_scan"]
    prof = profile_decode(torch, march, mparams, r["cache"], r["last_tok"])
    busy = (f"{prof['device_ms'] / prof['wall_ms']:.4f}" if prof["device_ms"]
            else "not measured")
    print(f"mamba2-2.7b arena decode step ({slots} slots): host wall "
          f"{prof['wall_ms']:.2f} ms, device kernel time "
          f"{prof['device_ms']:.2f} ms in {prof['kernel_launches']} kernels "
          f"(torch.profiler), device busy share {busy}; device ms by op: "
          f"{json.dumps(prof['top'])}", flush=True)
    pre = profile_prefill(torch, march, mparams, 512, 512 + max_new,
                          ("ssd_local_kernel", "ssd_chain_kernel",
                           "ssd_output_kernel"))
    dev = ("not measured" if not pre["device_ms"]
           else f"{pre['device_ms']:.3f} ms")
    print(f"mamba2-2.7b admission prefill (one 512-token prompt): host wall "
          f"{pre['wall_ms']:.2f} ms, device {dev} in "
          f"{pre['kernel_launches']} kernels (torch.profiler), of which B8 "
          f"{pre['kernel_ms']:.3f} ms in {pre['kernel_cuda_launches']} CUDA "
          f"launches ({mcfg.n_layers} calls) and the rest "
          f"{pre['rest_ms']:.3f} ms", flush=True)
    del mparams, r
    torch.cuda.empty_cache()

    # -- phase 5: full-width recurrentgemma-9b through the arena ------------
    phase(5, "recurrentgemma-9b on the arena")
    same_h, _, total_h = small_input_arena(torch, "recurrentgemma-9b")
    print(f"small input recurrentgemma-9b-smoke (window 16): card vs CPU "
          f"greedy tokens {same_h}/{total_h}; on the card slot == arena",
          flush=True)
    rarch = registry.build(rcfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rparams = schema.init_params(rarch.schema(), gen, "cuda",
                                 dtype=rcfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"recurrentgemma-9b params: "
          f"{schema.param_count(rarch.schema()) / 1e9:.2f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)", flush=True)
    prompts = hybrid_prompts(rcfg.vocab, seed=8)
    max_len = 2336
    win = min(rcfg.local_window, max_len)
    if max(len(p) for p in prompts) <= win:
        raise AssertionError("no prompt is longer than the ring window")
    r = serve_arena(torch, rarch, rparams, prompts, slots, max_new, max_len)
    print(f"serve recurrentgemma-9b arena: {n_requests} requests x {max_new} "
          f"tokens ({r['prompt_tokens']} prompt tokens, longest "
          f"{max(len(p) for p in prompts)} > window {win}: the rings wrap), "
          f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
          f"{r['decode_ms_per_iter_p50']:.2f} iterations={r['iterations']:.0f} "
          f"preemptions={r['preemptions']} prefills={r['prefills']} "
          f"state_bytes_per_slot={r['state_bytes_per_slot']} "
          f"kernels={json.dumps(r['launches'])}", flush=True)
    pattern, n_groups, tail = rcfg.layer_layout()
    n_rec = n_groups * pattern.count("R") + tail.count("R")
    if r["launches"]["rglru"] != n_rec * r["prefills"]:
        raise AssertionError(
            f"rglru launched {r['launches']['rglru']} times for "
            f"{r['prefills']} admission prefills of {n_rec} recurrent layers")
    main_counts["rglru"] = r["launches"]["rglru"]
    prof = profile_decode(torch, rarch, rparams, r["cache"], r["last_tok"])
    busy = (f"{prof['device_ms'] / prof['wall_ms']:.4f}" if prof["device_ms"]
            else "not measured")
    print(f"recurrentgemma-9b arena decode step ({slots} slots): host wall "
          f"{prof['wall_ms']:.2f} ms, device kernel time "
          f"{prof['device_ms']:.2f} ms in {prof['kernel_launches']} kernels "
          f"(torch.profiler), device busy share {busy}; device ms by op: "
          f"{json.dumps(prof['top'])}", flush=True)
    pre = profile_prefill(torch, rarch, rparams, 512, 512 + max_new,
                          ("rglru_kernel",), same_outputs=True)
    dev = ("not measured" if not pre["device_ms"]
           else f"{pre['device_ms']:.3f} ms")
    print(f"recurrentgemma-9b admission prefill (one 512-token prompt): host "
          f"wall {pre['wall_ms']:.2f} ms, device {dev} in "
          f"{pre['kernel_launches']} kernels (torch.profiler), of which B9 "
          f"{pre['kernel_ms']:.3f} ms in {pre['kernel_cuda_launches']} "
          f"launches ({n_rec} recurrent layers) and the rest "
          f"{pre['rest_ms']:.3f} ms", flush=True)
    if pre["kernel_cuda_launches"] != n_rec:
        raise AssertionError(f"the profiled prefill ran B9 "
                             f"{pre['kernel_cuda_launches']} times for "
                             f"{n_rec} recurrent layers")
    del rparams, r
    torch.cuda.empty_cache()

    # -- phase 6: the ITA integer path at full width ------------------------
    phase(6, "the ITA integer path")
    print_build(finish_builds(pending), t0)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ita = check_ita_attention(torch, cfg, scratch.zero_)
    del scratch
    entries.insert(-1, ita)
    print_entry(ita)
    print(f"kernel ita_attention: {ita['cases_checked']} cases bit-exact; "
          f"bound {ita['bound_ms']:.4f} ms at 20 int32 operations a kept "
          f"pair ({ita['bound_26_ms']:.4f} ms at the first body's 26); for "
          f"context, a different function (float SDPA, bf16, causal, kv "
          f"heads expanded) at the same shape: {ita['sdpa_ms']:.4f} ms",
          flush=True)
    print("kernel ita_attention per phase-6 width (event ms with L2 flushed, "
          "device ms (torch.profiler), bound ms at 20 int32 operations a "
          "kept pair, blocks for 132 SMs, warps a block, query heads a "
          "block, K/V stages, shared bytes a block): "
          + json.dumps({k: [round(v["ms"], 4), opt_ms(v["device_ms"]),
                            round(v["bound_ms"], 4), v["blocks"], v["warps"],
                            v["heads"], v["stages"], v["smem"]]
                        for k, v in ita["per_width"].items()}), flush=True)
    n_small = small_input_ita(torch)
    print(f"small input ITA: int8_attention and int_softmax card == CPU bit "
          f"for bit ({n_small} values)", flush=True)
    main_counts["ita_attention"] = main_counts["int_softmax"] = 0
    for r in ita_path(torch, cfg):
        smax = ("" if r["smax_ms"] is None else
                f", {r['layers']} x int_softmax {r['smax_ms']:.2f} ms")
        print(f"ita {r['name']} ({r['shape']}): {r['layers']} x "
              f"int8_attention {r['attn_ms']:.2f} ms per pass{smax}; "
              f"kernels={json.dumps(r['launches'])}; profiled pass: device "
              f"{r['device_ms']:.3f} ms, of which B6 {r['b6_device_ms']:.3f} "
              f"ms in {r['b6_launches']} launches (torch.profiler)",
              flush=True)
        if r["b6_launches"] != r["layers"]:
            raise AssertionError(f"{r['name']}: the profiled pass ran B6 "
                                 f"{r['b6_launches']} times")
        main_counts["ita_attention"] += r["launches"]["ita_attention"]
        main_counts["int_softmax"] += r["launches"]["int_softmax"]

    # -- phase 7: full-width gemma3-4b on the paged ring pools -------------
    phase(7, "gemma3-4b on the paged ring pools")
    same_f, total_f = small_input_ring_agreement(torch, quant=False)
    same_q, total_q = small_input_ring_agreement(torch, quant=True)
    print(f"small input gemma3-4b-smoke (window 16, ring pools): card vs CPU "
          f"greedy tokens: float {same_f}/{total_f}, int8 {same_q}/{total_q}",
          flush=True)
    garch_f = registry.build(dataclasses.replace(gcfg, serve_quant=False))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gparams = schema.init_params(garch_f.schema(), gen, "cuda",
                                 dtype=gcfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"gemma3-4b params: "
          f"{schema.param_count(garch_f.schema()) / 1e9:.2f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)", flush=True)
    garchs = {"bf16": garch_f, "int8": registry.build(gcfg)}
    prompts = ring_prompts(gcfg.vocab, seed=12)
    gruns = serve_ring(torch, gcfg, garchs, gparams, prompts, slots, max_new,
                       g_max_len, blk, spec_k)
    st = decode_steps(torch, garchs["int8"], gparams, slots, prompt_len=1100,
                      max_len=1312)
    print(f"gemma3-4b decode steps (int8 pools, {slots} slots running "
          f"1100-token prompts: ring rows rotating): step p50 "
          f"{st['step_ms_p50']:.2f} ms (host clock), device "
          f"{st['device_ms']:.3f} ms a step of which int8_gemm "
          f"{st['gemm_device_ms']:.3f} ms and paged_attention_int8 "
          f"{st['attn_device_ms']:.3f} ms, {st['kernels']:.0f} kernels a step "
          f"(torch.profiler)", flush=True)
    for name, label in (("paged_attention", "bf16"),
                        ("paged_attention_int8", "int8"),
                        ("int8_gemm", "int8")):
        main_counts[name] += gruns[label]["launches"][name]
    del gparams, gruns
    torch.cuda.empty_cache()

    # -- phase 8: full-width qwen3-moe-30b-a3b on the paged backend --------
    phase(8, "qwen3-moe-30b-a3b on the paged backend")
    for name, n in moe_phase(torch, qcfg, slots, max_new, spec_k).items():
        main_counts[name] += n

    # -- phase 9: full-width whisper-small (encdec) with embeds requests ----
    phase(9, "whisper-small (encdec) with embeds requests")
    for name, n in encdec_phase(torch, wcfg, slots, max_new, spec_k).items():
        main_counts[name] += n

    for e in entries:
        e["launches"] = main_counts[e["name"]]
    if {e["name"] for e in entries} != {k.name for k in all_kernels()}:
        raise AssertionError("a kernel of the port was not checked")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
