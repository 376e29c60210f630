"""How often ``torch.profiler`` loses the device records of kernels that ran,
and whether ``chip_smoke.profiled`` keeps them. Card only.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 profiler_loss.py [passes] [names]
    python3 profiler_loss.py smoke

The first form repeats the profiled passes of ``chip_smoke.py`` — phase 6's
ITA pass at each of its widths (``int8_attention`` once a layer:
MobileBERT, Whisper-Tiny encoder, DINOv2-S, a 2048-token glm4-9b prompt)
``passes`` times each (default 150), and phase 5's recurrentgemma-9b
512-token admission prefill a fifth as often — each in a bare
``torch.profiler`` session and in ``chip_smoke.profiled`` (a prologue of
empty spin kernels, host-idle margins inside both ends). ``names``
(comma-separated, default all) picks among ``mobilebert``, ``whisper``,
``dinov2``, ``glm4`` and ``rg``. For every session it counts the profiler's
records of the pass's kernel (B6, B9) against its launch counter, compares
the outputs with an unprofiled pass's bit for bit, notes whether the first
device record lies before the first host op (device records misplaced on
the host clock), and lists the host-side launch records that have no
device record (lost records, by their place in launch order). It exits
non-zero if any outputs differ.

The second form runs ``chip_smoke.py`` whole and prints, for each of its
profiled sessions, the launch records and the places of those that lost
their device record; it exits non-zero if any session lost a record that
is not the prologue's.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import chip_smoke as cs

PASSES = ("mobilebert", "whisper", "dinov2", "glm4", "rg")
LAUNCH_CALLS = ("LaunchKernel", "cuLaunch", "Memset", "Memcpy")


def lost_launches(prof):
    """(host-side launch records, places in launch order of those with no
    device record) of a finished raw ``torch.profiler`` session."""
    events = prof.profiler.kineto_results.events()
    calls = sorted((e for e in events
                    if not str(e.device_type()).endswith("CUDA")
                    and any(k in e.name() for k in LAUNCH_CALLS)),
                   key=lambda e: e.start_ns())
    on_dev = {e.correlation_id() for e in events
              if str(e.device_type()).endswith("CUDA")}
    return len(calls), [i for i, e in enumerate(calls)
                        if e.correlation_id() not in on_dev]


def session(torch, kind, fn):
    """(outputs, device events in start order, host events, launch
    records, lost places) of ``fn`` in one session."""
    from torch.profiler import ProfilerActivity, profile

    if kind == "bare":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        raw = prof
    else:
        with cs.profiled(torch) as prof:
            out = fn()
        raw = prof.prof
    evs = prof.events()
    dev = sorted((e for e in evs if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    host = [e for e in evs if not str(e.device_type).endswith("CUDA")]
    return (out, dev, host) + lost_launches(raw)


def repeat(torch, label, fn, kernel, key, expect, passes):
    want = fn()
    torch.cuda.synchronize()
    bad = 0
    for kind in ("bare", "profiled"):
        short = early = 0
        for _ in range(passes):
            n0 = kernel.launches
            out, dev, host, n_calls, lost = session(torch, kind, fn)
            recs = sum(1 for e in dev if key in e.name)
            launched = kernel.launches - n0
            same = cs.bit_equal(out, want)
            first_dev = dev[0].time_range.start
            first_host = min(e.time_range.start for e in host)
            short += recs != expect
            early += first_dev < first_host
            bad += not same
            print(f"{label} {kind}: {recs} records of {launched} launches, "
                  f"outputs {'bit-equal' if same else 'DIFFER'}, first "
                  f"device record {first_dev - first_host:+.1f} us from "
                  f"the first host op, {len(lost)} of {n_calls} launch "
                  f"records without a device record (at {lost[:20]})",
                  flush=True)
            del out, dev, host
        print(f"{label} {kind}: {short} of {passes} sessions short, device "
              f"records before the first host op in {early}", flush=True)
    return bad


def whole_smoke() -> None:
    """``chip_smoke.main()`` with every profiled session's lost records."""
    plain = cs.profiled
    seen = []

    @contextlib.contextmanager
    def logged(torch):
        with plain(torch) as prof:
            yield prof
        n_calls, lost = lost_launches(prof.prof)
        beyond = [i for i in lost if i >= cs.PROLOGUE_LAUNCHES]
        seen.append((n_calls, lost, beyond))
        print(f"profiled session {len(seen)}: {n_calls} launch records, "
              f"{len(lost)} without a device record (at {lost[:20]}), "
              f"{len(beyond)} of them past the prologue", flush=True)

    cs.profiled = logged
    os.chdir(cs.ROOT)
    cs.main()
    lost = [len(s[1]) for s in seen]
    print("profiled sessions: " + json.dumps(dict(
        sessions=len(seen), with_lost=sum(1 for n in lost if n),
        most_lost=max(lost, default=0),
        lost_past_prologue=sum(len(s[2]) for s in seen))), flush=True)
    if any(s[2] for s in seen):
        cs.fail("a profiled session lost a record past its prologue")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible; this script runs on the card")
    if sys.argv[1:] == ["smoke"]:
        whole_smoke()
        return
    from repro_torch import configs
    from repro_torch.kernels.build import all_kernels, build_all
    from repro_torch.models import registry, schema
    from repro_torch.models.attention import int8_attention

    passes = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    which = sys.argv[2].split(",") if len(sys.argv) > 2 else PASSES
    if set(which) - set(PASSES):
        cs.fail(f"unknown passes {sorted(set(which) - set(PASSES))}; "
                f"choose among {', '.join(PASSES)}")
    print(cs.card_line(), flush=True)
    build_all()
    kern = {k.name: k for k in all_kernels()}
    bad = 0

    cfg = configs.get_config("glm4-9b")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for short_name, width in zip(PASSES, cs.ita_widths(cfg)):
        if short_name not in which:
            continue
        name, layers, hq, hkv, s, d, causal, blk, _ = width
        qkv = [[torch.randn((1, h, s, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for h in (hq, hkv, hkv)]
               for _ in range(layers)]
        bad += repeat(torch, f"{name} ITA pass", lambda: [
            int8_attention(q, k, v, causal=causal, block_q=blk, block_kv=blk)
            for q, k, v in qkv], kern["ita_attention"],
            "ita_attention_kernel", layers, passes)
        del qkv

    if "rg" in which:
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
                      lambda: rarch.prefill(rparams, toks, 544),
                      kern["rglru"], "rglru_kernel", n_rec,
                      max(1, passes // 5))
    if bad:
        cs.fail(f"{bad} profiled passes gave other outputs than the "
                f"unprofiled pass")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f} s")
