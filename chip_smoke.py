"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each exits non-zero on failure; none is caught):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes glm4-9b's serving path gives it — the int8 GEMM bit-exact, paged
   attention allclose — and time kernel, plain version, a library yardstick
   (timed here, never called by the port) and the card's bound;
3. serve full-width glm4-9b (random weights from a seeded generator, depth
   as published) through ``LLMEngine(backend="paged")`` with bf16 pools and
   with int8 pools, with every launch count set to 0 just before and read
   just after each run; check every request finishes with its token count,
   the logits are finite, and the kernels' results agree with the CPU's
   plain versions on a small input.

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
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
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


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions at glm4-9b's serving shapes
# ---------------------------------------------------------------------------


def check_int8_gemm(torch, cfg, slots):
    from repro_torch.core import quant
    from repro_torch.kernels.int8_gemm import ops
    from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
              "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    layer = {}
    for name, (k, n) in shapes.items():
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        scale = torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev))
        mult, shift = quant.quantize_to_fixed_point(scale)
        bias = torch.randint(-20000, 20000, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        layer[name] = (w, bias, mult.to(torch.int32), shift.to(torch.int32))
    xs = {m: torch.randint(-127, 128, (m, max(d, f)), generator=g,
                           device=dev, dtype=torch.int8) for m in (1, slots)}
    n_checked = 0
    for m, x in xs.items():
        for name, (w, bias, mult, shift) in layer.items():
            xk = x[:, :w.shape[0]].contiguous()
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
                        f"int8_gemm {name} M={m} {act}: {bad} outputs differ")
                n_checked += 1
    # timing unit: one layer's seven W8A8 projections at M = slots
    x = xs[slots]
    args = [(x[:, :w.shape[0]].contiguous(), w, b, mu, sh)
            for w, b, mu, sh in layer.values()]

    def kernel():
        for a in args:
            ops.int8_gemm_cuda(*a)

    def plain():
        for a in args:
            int8_gemm_ref(*a)

    pad = 32  # torch._int_mm wants more than 16 rows
    lib_args = [(torch.cat([a[0], a[0].new_zeros(pad - slots, a[0].shape[1])]),)
                + a[1:] for a in args]
    try:
        torch._int_mm(*lib_args[0][:2])
    except RuntimeError:  # cuBLASLt's int8 GEMM may want B column-major
        lib_args = [(xp, w.t().contiguous().t()) + rest
                    for xp, w, *rest in lib_args]

    def library():
        for xp, w, b, mu, sh in lib_args:
            acc = torch._int_mm(xp, w) + b
            quant.requantize(acc, mu, sh)

    nbytes = sum(slots * w.shape[0] + w.numel() + 12 * w.shape[1]
                 + slots * w.shape[1] for w, *_ in layer.values())
    ops_n = sum(2 * slots * w.shape[0] * w.shape[1] for w, *_ in layer.values())
    b_ms, b_by = bound(nbytes, ops_n, "int8")
    return dict(
        name="int8_gemm", route="cuda",
        source="src/repro_torch/kernels/int8_gemm/csrc/int8_gemm.cu",
        replaces=ops.KERNEL.replaces.split()[0],
        max_abs_err=0.0, ms=timed(torch, kernel, 20),
        plain_ms=timed(torch, plain, 5), bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(torch, library, 20),
        shape=f"7 projections of one layer, M={slots} (library: M={pad})",
        cases_checked=n_checked)


def attention_case(torch, cfg, slots, lens, *, pool_dtype, int8, blk,
                   window=None, start=False, seed=1):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = max(-(-(max(lens) + 2 * blk) // blk), 1)
    n = slots * m + 1
    q = torch.randn((slots, hq, 1, d), generator=g, device=dev) * 2.0
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
    variants = [dict(), dict(window=100, start=True)]
    main_err = None
    for pool in pools:
        for var in variants:
            args, kw = attention_case(torch, cfg, slots, lens,
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
            if not var and pool in (torch.bfloat16, torch.int8):
                main_err = err
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
        library_ms=library_ms,
        shape=f"B={slots} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.hd} "
              f"blk={blk} lens={list(lens)}")


# ---------------------------------------------------------------------------
# Phase 3: the port's main path at full width
# ---------------------------------------------------------------------------


def serve(torch, arch, params, n_requests, slots, max_new, seed):
    from repro_torch.kernels.build import all_kernels
    from repro_torch.serve import EngineConfig, LLMEngine

    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, arch.cfg.vocab, int(rng.integers(64, 513))
                            ).astype(np.int32) for _ in range(n_requests)]
    eng = LLMEngine(arch, params, EngineConfig(
        slots=slots, max_len=512 + max_new, admit_window=2,
        scheduler="bounded", block_len=16))
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
    # the logits of one more decode step over the engine's pools are finite
    logits, _ = arch.paged_decode_step(
        params, eng.cache, eng.backend.last_tok, eng.backend._tables(),
        qparams=eng.backend.qparams)
    if tuple(logits.shape) != (slots, arch.cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"decode logits {tuple(logits.shape)} not finite")
    m = eng.metrics()
    return dict(
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        decode_ms_per_iter_p50=m["iter_wall_p50_ms"],
        iterations=m["iterations"], wall_s=wall,
        preemptions=sum(r.preemptions for r in reqs),
        prompt_tokens=int(sum(len(p) for p in prompts)),
        launches=counts)


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
    slots, blk, max_new = 8, 16, 32
    lens = [0, 1, 17, 64, 130, 255, 400, 544]
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    entries = [check_int8_gemm(torch, cfg, slots),
               check_attention(torch, cfg, slots, blk, lens, flush,
                               int8=False),
               check_attention(torch, cfg, slots, blk, lens, flush,
                               int8=True)]
    del scratch
    for e in entries:
        print(f"kernel {e['name']}: kernel_ms={e['ms']:.4f} "
              f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
              f"({e['bound_by']}) library_ms={e['library_ms']:.4f} "
              f"max_abs_err={e['max_abs_err']} [{e['shape']}]", flush=True)

    # -- phase 3: full-width glm4-9b through LLMEngine ----------------------
    same_f, total_f = small_input_agreement(torch, quant=False)
    same_q, total_q = small_input_agreement(torch, quant=True)
    print(f"small input, card vs CPU greedy tokens: float {same_f}/{total_f}, "
          f"int8 {same_q}/{total_q}", flush=True)
    arch_f = registry.build(dataclasses.replace(cfg, serve_quant=False))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = schema.init_params(arch_f.schema(), gen, "cuda",
                                dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"glm4-9b params: {schema.param_count(arch_f.schema()) / 1e9:.2f} B "
          f"({time.perf_counter() - t0:.1f} s to draw on the card)", flush=True)
    n_requests = 16
    runs = {}
    for label, arch in (("float", arch_f), ("int8", registry.build(cfg))):
        r = serve(torch, arch, params, n_requests, slots, max_new, seed=2)
        runs[label] = r
        print(f"serve {label}: {n_requests} requests x {max_new} tokens, "
              f"tokens/s={r['tokens_per_s']:.2f} decode_ms/iter(p50)="
              f"{r['decode_ms_per_iter_p50']:.2f} iterations={r['iterations']:.0f} "
              f"preemptions={r['preemptions']} kernels={json.dumps(r['launches'])}",
              flush=True)
    if runs["float"]["launches"]["paged_attention"] == 0:
        raise AssertionError("float run never launched paged_attention")
    for k in ("paged_attention_int8", "int8_gemm"):
        if runs["int8"]["launches"][k] == 0:
            raise AssertionError(f"int8 run never launched {k}")
    if runs["float"]["preemptions"] + runs["int8"]["preemptions"] == 0:
        raise AssertionError("no preemption happened")
    main_counts = {"paged_attention": runs["float"]["launches"]["paged_attention"],
                   "paged_attention_int8":
                       runs["int8"]["launches"]["paged_attention_int8"],
                   "int8_gemm": runs["int8"]["launches"]["int8_gemm"]}
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
