"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each exits non-zero on failure; none is caught):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes glm4-9b's serving path gives it — the int8 GEMM bit-exact on
   K-major weights (every projection at M = 1, decode's 8, verify's 40,
   and the 64-row tile edge 64 and 65; ragged shapes and int32-range
   biases), with its per-projection times, grids and device time a layer
   and ``torch._int_mm`` alone as a second yardstick, paged decode and
   verify attention
   allclose (also with lens on and beside their split boundaries, a window
   starting inside a split and a 4096-key row), verify at Q = 1 and in
   row 0 bit-equal to decode — and the SSD chunked scan
   at mamba2-2.7b's widths (S = 1, 5, 129, 512, 2048, and a G = 2 case of
   40 heads a group) allclose, y bit-equal with and without the state, with
   its device time, CUDA launches and grids a call, and the RG-LRU scan at
   recurrentgemma-9b's width (D = 4096; S = 1 to 2300 and a B = 3 case,
   bf16 and f32 inputs) allclose, the ITA fused attention at each width
   phase 6 runs (glm4-9b's prefill, DINOv2-S, Whisper-Tiny encoder,
   MobileBERT) and at a GQA-free case, 64- and 125-key tiles and the
   saturated causal corner bit-exact, and the ITA integer softmax at each
   paper network's per-layer logits (and ragged rows and columns)
   bit-exact; time kernel, plain version, a library
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
   and spec on gives spec off's greedy tokens on a small input; then time
   steady-state decode steps on both pool types (host clock, and device
   time a step with the int8 GEMM's share from ``torch.profiler``);
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
   prefill;
6. the ITA integer path at full width: ``int8_attention`` once per
   attention layer of MobileBERT, the Whisper-Tiny encoder, DINOv2-S and a
   2048-token glm4-9b prompt (bf16 inputs), and ``int_softmax`` once per
   layer on the three paper networks' [H·S, S] int8 logits, the launch
   counts set to 0 just before and read just after each network: B6
   launched once per attention layer, B7 once per paper-network layer,
   every output finite, and on a small input the card's ``int8_attention``
   and ``int_softmax`` equal the CPU's plain path bit for bit.

The last lines of stdout are a ``{"kernels": [...]}`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def on_device(prof):
        return {e.key: (dev_us(e), e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    with profile(activities=acts) as prof:
        flush()
        torch.cuda.synchronize()
    skip = set(on_device(prof))
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
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

    # timing unit: one layer's seven W8A8 projections at M = slots, and at
    # the verify pass's M = slots · (spec_tokens + 1)
    args, args_v = layer_args(slots), layer_args(verify_rows)

    def kernel():
        for a in args:
            ops.int8_gemm_cuda(*a)

    def kernel_verify():
        for a in args_v:
            ops.int8_gemm_cuda(*a)

    def plain():
        for a in args:
            int8_gemm_ref(*a)

    # cuBLASLt's int8 GEMM (torch._int_mm) wants more than 16 rows and B
    # column-major, which the K-major weights are
    pad = 32
    lib_args = [(torch.cat([a[0], a[0].new_zeros(pad - slots, a[0].shape[1])]),)
                + a[1:] for a in args]

    def library():
        for xp, w, b, mu, sh in lib_args:
            acc = torch._int_mm(xp, w) + b
            quant.requantize(acc, mu, sh)

    def library_mm():
        for xp, w, *_ in lib_args:
            torch._int_mm(xp, w)

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
    for m, a_m in ((slots, args), (verify_rows, args_v)):
        for name, a in zip(layer, a_m):
            per_proj[f"{name} M={m}"] = (
                timed(torch, lambda a=a: ops.int8_gemm_cuda(*a), 20, flush),
                gemm_bound(m, [name])[0], ops.grid(m, *shapes[name]))
    b_ms, b_by = gemm_bound(slots)
    bv_ms, _ = gemm_bound(verify_rows)
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
        per_proj=per_proj)


def attention_case(torch, cfg, slots, lens, *, pool_dtype, int8, blk,
                   window=None, start=False, seed=1, qlen=1):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = max(-(-(max(lens) + 2 * blk) // blk), 1)
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
    for b, s in [(1, s) for s in lengths] + [(3, 300)]:
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
    per_len = {s: timed(torch, lambda a=case(1, s, torch.bfloat16):
                        ops.rglru_cuda(*a), 20) for s in lengths}
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
        shape=f"B=1 S={main_len} D={d}, f32 log_a, bf16 u and h",
        errs=errs, per_len_ms=per_len)


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
    # the skipped tiles above the diagonal would change the result
    sl, d = 128, 64
    q = torch.full((1, 1, sl, d), 127, dtype=torch.int8, device="cuda")
    k = torch.full((1, 1, sl, d), -127, dtype=torch.int8, device="cuda")
    v = ita_inputs(torch, gen, 1, 1, 1, sl, sl, d, saturated=True)[2]
    for amax in (1000.0, 10.0):
        kw = dict(qk_scale=1.0, v_scale=1.0, out_scale=1.0, causal=True,
                  logit_amax=amax, block_q=64, block_kv=64)
        if not torch.equal(ops.ita_attention_cuda(q, k, v, **kw),
                           ita_plain(q, k, v, **kw)):
            raise AssertionError(f"ita_attention floor corner "
                                 f"(logit_amax {amax}) differs")
        n_checked += 1

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
    # work the mask keeps: row r attends min(r + 1, S) keys when causal.
    # Per kept (row, key) pair: the two int8 products over D (tensor-core
    # int8), and 26 scalar int32 operations on the CUDA cores: requantize
    # 9, alpha 3, tile max 1, exponent 2, exp2_fixed 8, p8 2, sum 1
    pairs = hq * s * (s + 1) // 2
    b_ms, b_by = bound(q.numel() * 2 + k.numel() * 2, 4 * hd * pairs,
                       "int8", int32=26 * pairs)
    return dict(
        name="ita_attention", route="cuda",
        source="src/repro_torch/kernels/ita_attention/csrc/ita_attention.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"B=1 Hq={hq} Hkv={hkv} S={s} D={hd} causal, 128-row tiles",
        cases_checked=n_checked, sdpa_ms=sdpa_ms)


def check_int_softmax(torch, cfg, flush):
    """Kernel B7 at each paper network's per-layer logits (phase 6; DINOv2-S's
    [6·1370, 1370] is timed) and at ragged rows and columns, bit-exact
    against ``int_softmax_ref``."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s_logit = 10.0 / 127

    def logits(r, c, scale):
        x = torch.randn((r, c), generator=gen, device="cuda") * 3.0
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)

    # each paper network's per-layer [H·S, S] logits (phase 6), then ragged
    paper = [(hq * sl, sl, s_logit) for _, _, hq, _, sl, _, _, _, on
             in ita_widths(cfg) if on]
    n_checked = 0
    for r, c, scale in paper + [(1001, 999, 0.06), (3, 1, s_logit),
                                (5, 4099, 60.0), (1, 100003, 0.06)]:
        x = logits(r, c, scale)
        y = ops.int_softmax_cuda(x, logit_scale=scale)
        want = int_softmax_ref(x, logit_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"int_softmax [{r}, {c}] scale {scale}: "
                                 f"{int((y != want).sum())} values differ")
        n_checked += 1
    x = logits(6 * 1370, 1370, s_logit)
    kernel_ms = timed(torch, lambda: ops.int_softmax_cuda(
        x, logit_scale=s_logit), 50, flush)
    plain_ms = timed(torch, lambda: int_softmax_ref(x, logit_scale=s_logit),
                     10, flush)
    # bytes: the int8 logits in, the uint8 probabilities out. Operations:
    # 17 scalar int32 per element on the CUDA cores (max 1, exponent 4 and
    # exp2_fixed 8 once, sum 1, e * 255 + den / 2 and the divide 3)
    b_ms, b_by = bound(2 * x.numel(), 17 * x.numel(), "int32")
    return dict(
        name="int_softmax", route="cuda",
        source="src/repro_torch/kernels/int_softmax/csrc/int_softmax.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape="[6x1370, 1370] int8 logits (DINOv2-S, one layer)",
        cases_checked=n_checked)


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


def serve(torch, arch, params, prompts, slots, max_new, **engine_kw):
    from repro_torch.kernels.build import all_kernels
    from repro_torch.serve import EngineConfig, LLMEngine

    eng = LLMEngine(arch, params, EngineConfig(
        slots=slots, max_len=512 + max_new, admit_window=2,
        scheduler="bounded", block_len=16, **engine_kw))
    for k in all_kernels():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_drained()
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
    k = engine_kw.get("spec_tokens", 0)
    if k:
        logits, _ = arch.paged_verify_step(
            params, eng.cache, torch.zeros((slots, k + 1), dtype=torch.int32,
                                           device="cuda"),
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
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        decode_ms_per_iter_p50=m["iter_wall_p50_ms"],
        iterations=m["iterations"], wall_s=wall,
        preemptions=sum(r.preemptions for r in reqs),
        prompt_tokens=int(sum(len(p) for p in prompts)),
        spec_accept_rate=m["spec_accept_rate"],
        spec_drafted=m["spec_drafted"], spec_accepted=m["spec_accepted"],
        prefix_cache_hit_rate=m.get("prefix_cache_hit_rate", 0.0),
        prefill_skip_rate=m.get("prefill_skip_rate", 0.0),
        launches=counts)


def decode_steps(torch, arch, params, slots, reps=25):
    """Steady-state decode iterations of ``LLMEngine`` (every slot running
    a 200-token prompt): the host-clock p50 of one step, and a step's device
    time from ``torch.profiler`` — all kernels, the int8 GEMM's share, and
    the number of kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import EngineConfig, LLMEngine

    rng = np.random.default_rng(5)
    eng = LLMEngine(arch, params, EngineConfig(slots=slots, max_len=512,
                                               block_len=16))
    for _ in range(slots):
        eng.add_request(rng.integers(0, arch.cfg.vocab, 200).astype(np.int32),
                        max_new_tokens=200)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    return dict(step_ms_p50=sorted(walls)[reps // 2],
                device_ms=sum(dev_us(e) for e in kernels) / n / 1e3,
                gemm_device_ms=sum(dev_us(e) for e in kernels
                                   if "int8_gemm" in e.key) / n / 1e3,
                kernels=sum(e.count for e in kernels) / n)


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
                        EngineConfig(slots=4, max_len=64, admit_window=2),
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
            slots=4, max_len=64, admit_window=2, block_len=8, spec_tokens=k,
            prefix_cache=True), device="cuda")
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[k] = [eng.request(h).output for h in hs]
    same = sum(a == b for x, y in zip(outs[4], outs[0]) for a, b in zip(x, y))
    total = sum(len(x) for x in outs[0])
    if same / total < 0.9:
        raise AssertionError(f"spec on vs off greedy tokens: {same}/{total}")
    return same, total


# ---------------------------------------------------------------------------
# Phase 4: the Mamba-2 family on the arena backend
# ---------------------------------------------------------------------------


def serve_arena(torch, arch, params, prompts, slots, max_new, max_len):
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
    handles = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in all_kernels()}
    reqs = [eng.request(h) for h in handles]
    for r in reqs:
        if len(r.output) != max_new or r.finish_reason != "length":
            raise AssertionError(
                f"request {r.rid}: {len(r.output)} tokens, {r.finish_reason}")
    logits, _ = arch.decode_step(params, eng.cache, eng.backend.last_tok)
    if tuple(logits.shape) != (slots, arch.cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    m = eng.metrics()
    preemptions = sum(r.preemptions for r in reqs)
    return dict(cache=eng.cache, last_tok=eng.backend.last_tok,
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        decode_ms_per_iter_p50=m["iter_wall_p50_ms"],
        iterations=m["iterations"], wall_s=wall, preemptions=preemptions,
        prefills=len(reqs) + preemptions,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        state_bytes_per_slot=sum(
            v[:, :1].numel() * v.element_size()
            for v in leaves(eng.cache) if v.dim() > 1),
        launches=counts)


def profile_decode(torch, arch, params, cache, tokens):
    """One arena decode step: host wall (synchronized, unprofiled) and the
    device's kernel time from ``torch.profiler``, with the ops that take the
    most device time. Device time 0 means the profiler saw no device
    activity (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.decode_step(params, cache, tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        arch.decode_step(params, cache, tokens)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # kernels are the device-side entries; each host op's self device time
    # is the time of the kernels it launched (the same kernels again)
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    ops = [e for e in avgs if not str(e.device_type).endswith("CUDA")]
    top = sorted(ops, key=dev_us, reverse=True)[:8]
    return dict(wall_ms=sorted(walls)[1],
                device_ms=sum(dev_us(e) for e in kernels) / 1e3,
                kernel_launches=sum(e.count for e in kernels),
                top={e.key: round(dev_us(e) / 1e3, 4) for e in top})


def profile_prefill(torch, arch, params, n_tokens, max_len):
    """One admission prefill of an ``n_tokens`` prompt (batch 1, as the
    arena admits one): host wall (synchronized, unprofiled) and device
    time from ``torch.profiler``, split into B8's launches and the rest."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    toks = torch.randint(0, arch.cfg.vocab, (1, n_tokens), generator=gen,
                         device="cuda")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.prefill(params, toks, max_len)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        arch.prefill(params, toks, max_len)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    b8 = [e for e in kernels if any(
        k in e.key for k in ("ssd_local_kernel", "ssd_chain_kernel",
                             "ssd_output_kernel"))]
    total = sum(dev_us(e) for e in kernels) / 1e3
    b8_ms = sum(dev_us(e) for e in b8) / 1e3
    return dict(wall_ms=sorted(walls)[1], device_ms=total, b8_ms=b8_ms,
                rest_ms=total - b8_ms, b8_launches=sum(e.count for e in b8),
                kernel_launches=sum(e.count for e in kernels))


def small_input_arena(torch, name):
    """``name``'s smoke config in float32 through the arena on the card
    (its kernel: B8 for mamba2-2.7b, B9 for recurrentgemma-9b) and on the
    CPU (plain versions): ≥ 90 % equal greedy tokens; on the card, the slot
    backend gives the arena's tokens."""
    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    cfg = dataclasses.replace(configs.smoke_config(name), dtype="float32")
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=SEED)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40))
                            ).astype(np.int32) for _ in range(6)]
    outs = {}
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
    if outs["cuda", "slot"] != outs["cuda", "arena"]:
        raise AssertionError(f"on the card, slot vs arena greedy tokens "
                             f"differ: {outs}")
    same = sum(a == b for x, y in zip(outs["cuda", "arena"],
                                      outs["cpu", "arena"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in outs["cpu", "arena"])
    if same / total < 0.9:
        raise AssertionError(f"{name} card vs CPU greedy tokens: "
                             f"{same}/{total} agree")
    return same, total


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
        runs.append(dict(name=name, layers=layers, attn_ms=attn_ms,
                         smax_ms=smax_ms if paper else None,
                         shape=f"{hq}/{hkv} heads, S={s}, D={d}, "
                               f"{'causal' if causal else 'bidirectional'}, "
                               f"tiles {blk}",
                         launches=counts))
        del qkv, logits, outs, probs
    return runs


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible; this script runs on the card")
    try:
        from repro_torch import configs
        from repro_torch.kernels.build import all_kernels, build_all
        from repro_torch.models import registry, schema
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card and the build ------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    logs = build_all()
    print(f"built {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {Path(src).name}: {line.strip()}")

    # -- phase 2: kernels vs plain versions ---------------------------------
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
               check_ita_attention(torch, cfg, flush),
               check_int_softmax(torch, cfg, flush)]
    del scratch
    for e in entries:
        lib = ("null" if e["library_ms"] is None
               else f"{e['library_ms']:.4f}")
        print(f"kernel {e['name']}: kernel_ms={e['ms']:.4f} "
              f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
              f"({e['bound_by']}) library_ms={lib} "
              f"max_abs_err={e['max_abs_err']} [{e['shape']}]", flush=True)
    ssd, lru, ita, smax = entries[-4:]

    def opt_ms(v):
        return "not measured" if v is None else f"{v:.4f}"

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
    print(f"kernel rglru max |err| per case: {json.dumps(lru['errs'])}; "
          f"kernel ms per S (B=1, bf16): "
          f"{json.dumps({s: round(t, 4) for s, t in lru['per_len_ms'].items()})}",
          flush=True)
    print(f"kernel ita_attention: {ita['cases_checked']} cases bit-exact; "
          f"for context, a different function (float SDPA, bf16, causal, "
          f"kv heads expanded) at the same shape: {ita['sdpa_ms']:.4f} ms",
          flush=True)
    print(f"kernel int_softmax: {smax['cases_checked']} cases bit-exact",
          flush=True)
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
    print("verify kernels at Q=1 and in row 0: bit-equal to decode (serving "
          "lens and split-boundary lens)", flush=True)

    # -- phase 3: full-width glm4-9b through LLMEngine ----------------------
    same_f, total_f = small_input_agreement(torch, quant=False)
    same_q, total_q = small_input_agreement(torch, quant=True)
    print(f"small input, card vs CPU greedy tokens: float {same_f}/{total_f}, "
          f"int8 {same_q}/{total_q}", flush=True)
    same_f, total_f = small_input_spec_agreement(torch, quant=False)
    same_q, total_q = small_input_spec_agreement(torch, quant=True)
    print(f"small input on the card, spec on vs off greedy tokens: float "
          f"{same_f}/{total_f}, int8 {same_q}/{total_q}", flush=True)
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
    runs = {}
    for label, pool, prompts, kw in (
            ("float", "float", plain, {}),
            ("int8", "int8", plain, {}),
            ("float prefix", "float", shared, dict(prefix_cache=True)),
            ("float spec+prefix", "float", shared,
             dict(prefix_cache=True, spec_tokens=spec_k)),
            ("int8 prefix", "int8", shared, dict(prefix_cache=True)),
            ("int8 spec+prefix", "int8", shared,
             dict(prefix_cache=True, spec_tokens=spec_k))):
        r = serve(torch, archs[pool], params, prompts, slots, max_new, **kw)
        runs[label] = r
        print(f"serve {label}: {n_requests} requests x {max_new} tokens "
              f"({r['prompt_tokens']} prompt tokens), "
              f"tokens/s={r['tokens_per_s']:.2f} iter_ms(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iterations={r['iterations']:.0f} "
              f"preemptions={r['preemptions']} "
              f"spec_accept_rate={r['spec_accept_rate']:.4f} "
              f"(drafted {r['spec_drafted']:.0f}, accepted {r['spec_accepted']:.0f}) "
              f"prefix_cache_hit_rate={r['prefix_cache_hit_rate']:.4f} "
              f"prefill_skip_rate={r['prefill_skip_rate']:.4f} "
              f"kernels={json.dumps(r['launches'])}", flush=True)
    need = {"float": ["paged_attention"],
            "int8": ["paged_attention_int8", "int8_gemm"],
            "float spec+prefix": ["paged_attention_verify"],
            "int8 spec+prefix": ["paged_attention_verify_int8", "int8_gemm"]}
    for label, names in need.items():
        for k in names:
            if runs[label]["launches"][k] == 0:
                raise AssertionError(f"{label} run never launched {k}")
    if runs["float"]["preemptions"] + runs["int8"]["preemptions"] == 0:
        raise AssertionError("no preemption happened")
    for label in ("float prefix", "int8 prefix", "float spec+prefix",
                  "int8 spec+prefix"):
        if runs[label]["prefix_cache_hit_rate"] <= 0:
            raise AssertionError(f"{label} run had no prefix-cache hit")
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
    del params
    torch.cuda.empty_cache()

    # -- phase 4: full-width mamba2-2.7b through LLMEngine(backend="arena") -
    same_m, total_m = small_input_arena(torch, "mamba2-2.7b")
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
    pre = profile_prefill(torch, march, mparams, 512, 512 + max_new)
    dev = ("not measured" if not pre["device_ms"]
           else f"{pre['device_ms']:.3f} ms")
    print(f"mamba2-2.7b admission prefill (one 512-token prompt): host wall "
          f"{pre['wall_ms']:.2f} ms, device {dev} in "
          f"{pre['kernel_launches']} kernels (torch.profiler), of which B8 "
          f"{pre['b8_ms']:.3f} ms in {pre['b8_launches']} CUDA launches "
          f"({mcfg.n_layers} calls) and the rest {pre['rest_ms']:.3f} ms",
          flush=True)
    del mparams, r
    torch.cuda.empty_cache()

    # -- phase 5: full-width recurrentgemma-9b through the arena ------------
    same_h, total_h = small_input_arena(torch, "recurrentgemma-9b")
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
    del rparams, r
    torch.cuda.empty_cache()

    # -- phase 6: the ITA integer path at full width ------------------------
    n_small = small_input_ita(torch)
    print(f"small input ITA: int8_attention and int_softmax card == CPU bit "
          f"for bit ({n_small} values)", flush=True)
    main_counts["ita_attention"] = main_counts["int_softmax"] = 0
    for r in ita_path(torch, cfg):
        smax = ("" if r["smax_ms"] is None else
                f", {r['layers']} x int_softmax {r['smax_ms']:.2f} ms")
        print(f"ita {r['name']} ({r['shape']}): {r['layers']} x "
              f"int8_attention {r['attn_ms']:.2f} ms per pass{smax}; "
              f"kernels={json.dumps(r['launches'])}", flush=True)
        main_counts["ita_attention"] += r["launches"]["ita_attention"]
        main_counts["int_softmax"] += r["launches"]["int_softmax"]

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
