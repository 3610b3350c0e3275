#!/usr/bin/env python3
"""How often torch.profiler drops device events from a short window, with
and without host pauses around the traced call, on one NVIDIA GPU.

    python3 port_profiler_windows.py [--windows N] [--pauses 0,0.03]

Each window is ``chip_smoke.profiled_events``'s: a warm-up step, then one
traced step of five ``cuda_warp.warp_batch`` forwards (8 cuts of a
224x597x3 canvas into 224, reflection), ended by a synchronize.  With a
pause of P seconds the host idles P before the call and P after its
synchronize, inside the step.  Pauses alternate in rounds of 50 windows.
For each pause it prints the windows taken, those with no device event,
those with fewer than the most any window listed, the device event counts
seen, and the least and median ms between the traced step's start and its
first device event (lead) and between its last device event and the step's
end (tail).
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

ROUND = 50


def window(fn, pause):
    """(device events, (lead ms, tail ms) or None) of one traced call of ``fn``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    traces = []
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule,
                                on_trace_ready=lambda p: traces.append(list(p.events()))) as prof:
        for _ in range(2):
            time.sleep(pause)
            fn()
            torch.cuda.synchronize()
            time.sleep(pause)
            prof.step()
    events = traces[-1]
    on_card = lambda e: e.device_type == torch.autograd.DeviceType.CUDA
    devs = [e for e in events if on_card(e) and not e.name.startswith("ProfilerStep")]
    steps = [e for e in events if not on_card(e) and e.name.startswith("ProfilerStep")]
    if not (devs and steps):
        return len(devs), None
    span = steps[0].time_range
    return len(devs), ((min(e.time_range.start for e in devs) - span.start) / 1e3,
                       (span.end - max(e.time_range.end for e in devs)) / 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=300, help="windows per pause")
    ap.add_argument("--pauses", default=f"0,{cs.PROFILER_PAUSE_S}", help="host pauses in seconds, comma separated")
    args = ap.parse_args()

    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops import warp as W

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cs.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    h, w, s, n = 224, 597, 224, 8
    u = lambda *shape: torch.rand(shape, generator=gen)
    ms = W.mm3(W.random_resized_crop(h, w, s, u(n) * 0.6 + 0.3, torch.zeros(n), u(n), u(n)),
               W.random_perspective(h, w, 0.4, u(n, 4, 2)))
    work = torch.rand((h, w, 3), generator=gen).to(dev)

    def fn():
        with torch.no_grad():
            for _ in range(5):
                cuda_warp.warp_batch(work, ms, s, "reflection", 0.5)

    pauses = [float(p) for p in args.pauses.split(",")]
    for _ in range(3):
        window(fn, 0.0)
    res = {p: [] for p in pauses}
    while any(len(r) < args.windows for r in res.values()):
        for p in pauses:
            for _ in range(min(ROUND, args.windows - len(res[p]))):
                res[p].append(window(fn, p))
    most = max(nd for r in res.values() for nd, _ in r)
    for p, r in res.items():
        lead = [g[0] for _, g in r if g]
        tail = [g[1] for _, g in r if g]
        margins = (f"lead ms least {min(lead):.3f}, median {statistics.median(lead):.3f}; tail ms least "
                   f"{min(tail):.3f}, median {statistics.median(tail):.3f}" if lead else "no margins")
        print(f"pause {p} s: {len(r)} windows, {sum(nd == 0 for nd, _ in r)} with no device event, "
              f"{sum(0 < nd < most for nd, _ in r)} with fewer than {most}; device event counts "
              f"{sorted(set(nd for nd, _ in r))}; {margins}", flush=True)


if __name__ == "__main__":
    main()
