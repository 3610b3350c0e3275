#!/usr/bin/env python3
"""Profile the PyTorch port's step on one NVIDIA GPU, row by row.

    python3 port_profile.py [--root DIR] [--label NAME] [--rows pixel,clipdraw,vqgan]

``--root`` imports ``pixray_tpu_torch`` from another checkout (default:
this one), so that two trees are measured in one call on one card, in
turns (parent, change, change, parent); the harness (this file and
``chip_smoke.py``'s timers and configs) is always this checkout's.  Per
bench row (``chip_smoke.py``'s restatement of ``bench.py``'s configs):

- steps/s: 9 warm-up and 24 timed steps, a host read of the loss after
  each, as ``chip_smoke.py`` times them;
- the split of a step over 10 steps, each ended by a synchronize: host ms
  drawing, host ms enqueueing ``Engine.train``, ms the device runs on after
  the host is done (medians);
- ``torch.profiler`` over 5 steps: device events and kernels per step,
  device busy per step (the union of device intervals), and the cutout
  module's device ms per step (``render_cutouts``' forward and its backward,
  bracketed by 1-cycle ``torch.cuda._sleep`` marker kernels on the stream)
  with its kernels by name.

Before the rows, at the flagship bank (the 224x224x3 work canvas of a
384x216 canvas, 64 cuts of 224, bf16, the step's own draws), each as summed
kernel time and median CUDA-event time of one call, through the interfaces
every tree of the port has: ``render_cutouts`` forward and backward, and
the bare warp (``cuda_warp.launch_fwd`` / ``launch_bwd``, f32, the bank's
45 perspective cuts).  The bank kernels with their epilogue, and
``grid_sample``, are timed by ``chip_smoke.py``.  Prints one JSON line and
writes it to ``chiprun_out/profile_<label>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_STEPS = 5
SPLIT_STEPS = 10
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def _install_markers(cutouts_module):
    """Wrap ``render_cutouts`` so that its forward and its backward are each
    bracketed by a marker kernel on the stream."""
    import torch

    orig = cutouts_module.render_cutouts

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            torch.cuda._sleep(1)
            return g

    def render_cutouts(work, *args, **kwargs):
        torch.cuda._sleep(1)
        out = orig(Mark.apply(work), *args, **kwargs)
        torch.cuda._sleep(1)
        return Mark.apply(out)

    cutouts_module.render_cutouts = render_cutouts


def _device_profile(events, steps):
    """Per-step device numbers from a profiler's events (device events in
    stream order; a marker kernel toggles 'inside the cutout module')."""
    import torch

    dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    inside, cut_us, cut_names, intervals = False, 0.0, {}, []
    kernels = 0
    for e in dev:
        if MARKER in e.name:
            inside = not inside
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
        if inside:
            cut_us += end - start
            n, us = cut_names.get(e.name, (0, 0.0))
            cut_names[e.name] = (n + 1, us + end - start)
    busy, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    top = sorted(cut_names.items(), key=lambda kv: -kv[1][1])
    return {
        "device_events_per_step": len(intervals) / steps,
        "kernels_per_step": kernels / steps,
        "device_busy_ms": busy / 1e3 / steps,
        "cutouts_device_ms": cut_us / 1e3 / steps,
        "cutouts_kernels_per_step": sum(n for n, _ in cut_names.values()) / steps,
        "cutouts_top": [[name[:90], n / steps, us / 1e3 / steps] for name, (n, us) in top[:12]],
    }


def profile_row(cs, label, config, tmp):
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    steps = cs.WARMUP_STEPS + cs.TIMED_STEPS
    _, losses, launches, _, elapsed = cs.drive_path(dict(config, iterations=1000), tmp, steps, cs.WARMUP_STEPS)
    rate = cs.TIMED_STEPS / elapsed

    engine = Engine(apply_settings(dict(config, outdir=tmp, iterations=1000), apply_side_effects=False),
                    device="cuda")
    it = 0
    for _ in range(3):  # warm up
        engine.train(it)
        it += 1
    torch.cuda.synchronize()
    draws_ms, enqueue_ms, after_ms, step_ms = [], [], [], []
    for _ in range(SPLIT_STEPS):
        t0 = time.perf_counter()
        draws = engine.draw_step()
        t1 = time.perf_counter()
        engine.train(it, draws)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        it += 1
        draws_ms.append(1e3 * (t1 - t0))
        enqueue_ms.append(1e3 * (t2 - t1))
        after_ms.append(1e3 * (t3 - t2))
        step_ms.append(1e3 * (t3 - t0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            engine.train(it)
            it += 1
        torch.cuda.synchronize()
    med = statistics.median
    return {"row": label, "steps_per_s": rate, "losses_first_last": [losses[0], losses[-1]],
            "launches": launches, "step_ms": med(step_ms), "host_draws_ms": med(draws_ms),
            "host_enqueue_ms": med(enqueue_ms), "device_after_host_ms": med(after_ms),
            **_device_profile(prof.events(), PROFILE_STEPS)}


def _times(cs, fn):
    """(summed kernel ms of one call, median CUDA-event ms of one call)."""
    return {"device_ms": cs.device_ms(fn), "event_ms": cs.median_ms(fn)}


def flagship_bank(cs):
    """render_cutouts forward and backward at the flagship bank, and the
    bare warp at the bank's 45 perspective cuts."""
    import torch

    from pixray_tpu_torch.engine import cutouts as C
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3

    dev = torch.device("cuda")
    gen, gen_dev = torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(0)
    aspect = 384 / 216
    draws = C.draw_step_cutouts(gen, gen_dev, 64, 224, aspect, torch.bfloat16, dev)
    work = torch.rand((224, 224, 3), generator=gen).to(dev)
    kw = dict(reflect_padding=True, fill_color=0.37, jitter=draws["jitter"], noise=draws["noise"],
              compute_dtype=torch.bfloat16)
    w_req = work.clone().requires_grad_(True)
    out = C.render_cutouts(w_req, draws["transforms"], 224, **kw)
    g = torch.randn(out.shape, device=dev, generator=gen_dev).to(out.dtype)

    def fwd():
        with torch.no_grad():
            C.render_cutouts(work, draws["transforms"], 224, **kw)

    def bwd():
        torch.autograd.grad(out, w_req, g, retain_graph=True)

    zoom, wide = draws["transforms"]
    nzp, nwp = C.persp_split(zoom.shape[0])[0], C.persp_split(wide.shape[0])[0]
    inv = inv3x3(torch.cat([zoom[:nzp], wide[:nwp]]).float()).to(dev).contiguous()
    modes = torch.tensor([i % 2 for i in range(nzp)] + [3] * nwp, dtype=torch.int32, device=dev)
    g45 = torch.randn((inv.shape[0], 3, 224, 224), device=dev, generator=gen_dev)
    return {
        "render_cutouts_fwd": _times(cs, fwd),
        "render_cutouts_bwd": _times(cs, bwd),
        "warp_only_fwd_45": _times(cs, lambda: cuda_warp.launch_fwd(work, inv, modes, 0.37, 224)),
        "warp_only_bwd_45": _times(cs, lambda: cuda_warp.launch_bwd(g45, inv, modes, (224, 224, 3), 224)),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose pixray_tpu_torch is measured")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default="pixel,clipdraw,vqgan")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import pixray_tpu_torch
    from pixray_tpu_torch.engine import cutouts

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.build_all()
    out = {"label": args.label, "package": os.path.dirname(pixray_tpu_torch.__file__), "card": card,
           "flagship_bank": flagship_bank(cs)}
    _install_markers(cutouts)
    configs = {"pixel": cs.PIXEL_CONFIG, "clipdraw": cs.CLIPDRAW_CONFIG, "vqgan": cs.VQGAN_CONFIG}
    out["rows"] = []
    for row in args.rows.split(","):
        with tempfile.TemporaryDirectory() as tmp:
            out["rows"].append(profile_row(cs, row, configs[row], tmp))
        torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"profile_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    for name, t in out["flagship_bank"].items():
        print(f"{args.label} flagship {name}: {t['device_ms']:.4f} ms of kernels, {t['event_ms']:.4f} ms "
              f"CUDA events; on {card}", flush=True)
    for r in out["rows"]:
        print(f"{args.label} {r['row']}: {r['steps_per_s']:.3f} steps/s; step {r['step_ms']:.3f} ms = draws "
              f"{r['host_draws_ms']:.3f} + enqueue {r['host_enqueue_ms']:.3f} + device after host "
              f"{r['device_after_host_ms']:.3f}; {r['kernels_per_step']:.1f} kernels "
              f"({r['device_events_per_step']:.1f} device events) per step, device busy {r['device_busy_ms']:.3f} ms; "
              f"cutouts {r['cutouts_device_ms']:.3f} ms in {r['cutouts_kernels_per_step']:.1f} kernels; on {card}",
              flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
