"""How often ``torch.profiler`` loses the device records of kernels that ran,
and whether ``chip_smoke.profiled`` keeps them. Card only.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 profiler_loss.py [passes]

It repeats two profiled passes of ``chip_smoke.py`` — phase 6's glm4-9b ITA
pass (40 x ``int8_attention`` over a 2048-token prompt) ``passes`` times
(default 150), and phase 5's recurrentgemma-9b 512-token admission prefill
a fifth as often — each in a bare ``torch.profiler`` session and in
``chip_smoke.profiled`` (host-idle margins inside both ends of the session).
For every session it counts the profiler's records of the pass's kernel (B6,
B9) against its launch counter, compares the outputs with an unprofiled
pass's bit for bit, and notes whether the first device record lies before
the first host op (device records misplaced on the host clock). It prints
one line a pass and session kind, and exits non-zero if any outputs differ.
"""

from __future__ import annotations

import sys
import time

import chip_smoke as cs


def session(torch, kind, fn):
    """(outputs, device events, host events) of ``fn`` in one session."""
    from torch.profiler import ProfilerActivity, profile

    if kind == "bare":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    else:
        with cs.profiled(torch) as prof:
            out = fn()
    evs = prof.events()
    dev = [e for e in evs if str(e.device_type).endswith("CUDA")]
    host = [e for e in evs if not str(e.device_type).endswith("CUDA")]
    return out, dev, host


def repeat(torch, label, fn, kernel, key, expect, passes):
    want = fn()
    torch.cuda.synchronize()
    bad = 0
    for kind in ("bare", "margins"):
        short = early = 0
        for _ in range(passes):
            n0 = kernel.launches
            out, dev, host = session(torch, kind, fn)
            recs = sum(1 for e in dev if key in e.name)
            launched = kernel.launches - n0
            same = cs.bit_equal(out, want)
            first_dev = min(e.time_range.start for e in dev)
            first_host = min(e.time_range.start for e in host)
            short += recs != expect
            early += first_dev < first_host
            bad += not same
            print(f"{label} {kind}: {recs} records of {launched} launches, "
                  f"outputs {'bit-equal' if same else 'DIFFER'}, first "
                  f"device record {first_dev - first_host:+.1f} us from "
                  f"the first host op", flush=True)
            del out, dev, host
        print(f"{label} {kind}: {short} of {passes} sessions short, device "
              f"records before the first host op in {early}", flush=True)
    return bad


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible; this script runs on the card")
    from repro_torch import configs
    from repro_torch.kernels.build import all_kernels, build_all
    from repro_torch.models import registry, schema
    from repro_torch.models.attention import int8_attention

    passes = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    print(cs.card_line(), flush=True)
    build_all()
    kern = {k.name: k for k in all_kernels()}

    cfg = configs.get_config("glm4-9b")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    _, layers, hq, hkv, s, d, causal, blk, _ = cs.ita_widths(cfg)[3]
    qkv = [[torch.randn((1, h, s, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for h in (hq, hkv, hkv)]
           for _ in range(layers)]
    bad = repeat(torch, "glm4-9b ITA pass", lambda: [
        int8_attention(q, k, v, causal=causal, block_q=blk, block_kv=blk)
        for q, k, v in qkv], kern["ita_attention"], "ita_attention_kernel",
        layers, passes)
    del qkv

    rcfg = configs.get_config("recurrentgemma-9b")
    rarch = registry.build(rcfg)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rparams = schema.init_params(rarch.schema(), gen, "cuda",
                                 dtype=rcfg.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    toks = torch.randint(0, rcfg.vocab, (1, 512), generator=gen,
                         device="cuda")
    pattern, n_groups, tail = rcfg.layer_layout()
    n_rec = n_groups * pattern.count("R") + tail.count("R")
    bad += repeat(torch, "recurrentgemma-9b prefill",
                  lambda: rarch.prefill(rparams, toks, 544), kern["rglru"],
                  "rglru_kernel", n_rec, max(1, passes // 5))
    if bad:
        cs.fail(f"{bad} profiled passes gave other outputs than the "
                f"unprofiled pass")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f} s")
