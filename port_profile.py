#!/usr/bin/env python3
"""Profile the PyTorch port's step on one NVIDIA GPU, row by row.

    python3 port_profile.py [--root DIR] [--label NAME] [--rows pixel,clipdraw,vqgan,fft,image,anim,rn50,mixed]

(``--rows ""`` measures no row; a tree without the fft drawer takes
``--rows pixel,clipdraw,vqgan``, one without the image inputs
``--rows pixel,clipdraw,vqgan,fft``, one without the animation ring
``--rows pixel,clipdraw,vqgan,fft,image``, one without the ResNet and
SLIP towers ``--rows pixel,clipdraw,vqgan,fft,image,anim``.)  The rn50 row
is the pixel row under RN50; the mixed row the pixel row under
``--perceptors mixed --quality better`` (RN50, ViT-B/16 and SLIP_VITB16,
36 cuts each).  The image row is the pixel row with
``chip_smoke.py``'s image inputs (an init image, an image prompt, spot and
spot_off prompts, a target image and a label, PNGs written per row).  The
anim row is the pixel row with ``chip_smoke.py``'s animation inputs (3
frames: the init, image-prompt and target globs), its step as frame 0's
(the frame's target row and forward-only image-prompt bank), without the
frame spans' checkins (``save_every`` as the pixel row's).

``--root`` imports ``pixray_tpu_torch`` from another checkout (default:
this one), so that two trees are measured in one call on one card, in
turns (parent, change, change, parent); the harness (this file and
``chip_smoke.py``'s timers and configs) is always this checkout's.  Per
bench row (``chip_smoke.py``'s restatement of ``bench.py``'s configs),
eager (``--steps_per_call 1``) and, where the tree has blocked dispatch,
blocked (the default, blocks of 8 steps as CUDA graph replays):

- steps/s: 9 warm-up and 24 timed steps, a host read of the loss after
  each, as ``chip_smoke.drive_path`` times them (blocked: the steps
  dispatched after the warm-up);
- eager, the split of a step over 10 steps, each ended by a synchronize:
  host ms drawing, host ms enqueueing ``Engine.train``, ms the device runs
  on after the host is done (medians); blocked, over 4 blocks walked after
  the capture (no synchronize): host ms per step spent dispatching (the
  draws of 8 steps, their staging and the replay's enqueue, which happen
  while the device runs the block before) and wall ms per step (medians);
- ``torch.profiler`` (``chip_smoke.profiled_events``, after a warm-up call
  of the profiler) over 5 eager steps, each ended by a synchronize, or 2
  walked blocks, each ended by one: device events and kernels per step,
  device busy per step (the union of device intervals), and the cutout
  module's device ms per step (the bank's forward and its backward,
  bracketed by 1-cycle ``torch.cuda._sleep`` marker kernels on the stream,
  inside the graph too) with its kernels by name, and the step's 20
  costliest kernels by name (count and device ms per step; JSON only).

Before the rows, at the flagship bank (the 224x224x3 work canvas of a
384x216 canvas, 64 cuts of 224, bf16, the step's own draws), each as summed
kernel time and median CUDA-event time of one call, through the interfaces
every tree of the port has: ``render_cutouts`` forward and backward, and
the bare warp (``cuda_warp.launch_fwd`` / ``launch_bwd``, f32, the bank's
45 perspective cuts).  The bank kernels with their epilogue, and
``grid_sample``, are timed by ``chip_smoke.py``.  Then the stroke path at
the clipdraw flagship scene (``ClipDrawer``'s own init: 1024 strokes, P =
25, 384x216, white) through ``cuda_strokes.render_strokes_auto``, the
interface every tree of the port has: its forward with a gradient to take
(K4s) and its backward (K5), each as the stroke kernel's own device time,
the summed kernel time and the median CUDA-event time of one call; and the
same with the strokes moved two canvas widths off the canvas, where the
kernels do nothing but walk.  Prints one JSON line and
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


def _install_markers():
    """Wrap the bank the step calls (``cuda_warp.cutout_bank``, or
    ``cutouts.render_cutouts`` in a tree whose step calls that) so that its
    forward and its backward are each bracketed by a marker kernel on the
    stream."""
    import torch

    from pixray_tpu_torch.engine import cutouts
    from pixray_tpu_torch.ops import cuda_warp

    module, name = (cuda_warp, "cutout_bank") if hasattr(cutouts, "pack_cutouts") else (cutouts, "render_cutouts")
    orig = getattr(module, name)

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            torch.cuda._sleep(1)
            return g

    def marked(work, *args, **kwargs):
        torch.cuda._sleep(1)
        out = orig(Mark.apply(work), *args, **kwargs)
        torch.cuda._sleep(1)
        return Mark.apply(out)

    setattr(module, name, marked)


def _device_profile(events, steps):
    """Per-step device numbers from a profiler's events (device events in
    stream order; a marker kernel toggles 'inside the cutout module')."""
    import torch

    dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    inside, cut_us, cut_names, intervals, all_names = False, 0.0, {}, [], {}
    kernels = 0
    for e in dev:
        if MARKER in e.name:
            inside = not inside
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        n, us = all_names.get(e.name, (0, 0.0))
        all_names[e.name] = (n + 1, us + end - start)
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
    top_all = sorted(all_names.items(), key=lambda kv: -kv[1][1])
    return {
        "device_events_per_step": len(intervals) / steps,
        "kernels_per_step": kernels / steps,
        "device_busy_ms": busy / 1e3 / steps,
        "cutouts_device_ms": cut_us / 1e3 / steps,
        "cutouts_kernels_per_step": sum(n for n, _ in cut_names.values()) / steps,
        "cutouts_top": [[name[:90], n / steps, us / 1e3 / steps] for name, (n, us) in top[:12]],
        "top_kernels": [[name[:90], n / steps, us / 1e3 / steps] for name, (n, us) in top_all[:20]],
    }


def profile_row(cs, label, config, tmp, blocked):
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    config = dict(config, iterations=1000, steps_per_call=0 if blocked else 1)
    steps = cs.WARMUP_STEPS + cs.TIMED_STEPS
    _, losses, launches, _, elapsed, timed = cs.drive_path(config, tmp, steps, cs.WARMUP_STEPS)
    rate = timed / elapsed
    head = {"row": label, "mode": "blocked" if blocked else "eager", "steps_per_s": rate,
            "losses_first_last": [losses[0], losses[-1]], "launches": launches}

    engine = Engine(apply_settings(dict(config, outdir=tmp), apply_side_effects=False), device="cuda")
    if blocked:
        return {**head, **_blocked_split(cs, engine)}
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
    steps = iter(range(it, it + PROFILE_STEPS + 1))
    events = cs.profiled_events(lambda: engine.train(next(steps)), PROFILE_STEPS)
    med = statistics.median
    return {**head, "step_ms": med(step_ms), "host_draws_ms": med(draws_ms),
            "host_enqueue_ms": med(enqueue_ms), "device_after_host_ms": med(after_ms),
            **_device_profile(events, PROFILE_STEPS)}


def _blocked_split(cs, engine):
    """Host and device numbers per step of a blocked engine, walked in whole
    blocks of 8 from step 1 (step 0 is the checkin's eager step)."""
    import torch

    n = engine._want()
    dispatch_ms = []
    dispatch = engine._dispatch_block

    def timed_dispatch(cur_it, count):
        t0 = time.perf_counter()
        out = dispatch(cur_it, count)
        dispatch_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    engine._dispatch_block = timed_dispatch
    it = 0

    def walk(steps):
        nonlocal it
        for _ in range(steps):
            engine.train(it)
            it += 1

    walk(1 + 2 * n)  # step 0, then the capture and one more block
    torch.cuda.synchronize()
    dispatch_ms.clear()
    wall_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        walk(n)
        wall_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    events = cs.profiled_events(lambda: walk(n), 2)
    med = statistics.median
    blk = engine.step_block
    return {"capture_s": blk.capture_s, "step_ms": med(wall_ms) / n, "host_dispatch_ms": med(dispatch_ms) / n,
            "blocks_per_walk": n, **_device_profile(events, 2 * n)}


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


def flagship_strokes(cs):
    """render_strokes_auto forward (K4s) and backward (K5) at the clipdraw
    flagship scene, on the canvas and moved off it."""
    from types import SimpleNamespace

    import torch

    from pixray_tpu_torch.drawers.clipdraw import ClipDrawer
    from pixray_tpu_torch.ops import cuda_strokes

    w, h = cs.CLIPDRAW_CONFIG["size"]
    drawer = ClipDrawer(SimpleNamespace(size=[w, h], strokes=1024, min_stroke_width=1, max_stroke_width=5))
    drawer.snap_canvas([w, h])
    z = drawer.init_params(torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    basis = drawer.model_params["basis"].to(dev)
    bg = torch.ones((h, w, 3), device=dev)
    out = {}
    for label, shift in (("on_canvas", 0.0), ("off_canvas", 2.0 * w)):
        leaves = (z["points"].to(dev) + torch.tensor([shift, 0.0], device=dev), z["widths"].to(dev),
                  z["colors"].to(dev))
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        img = cuda_strokes.render_strokes_auto(*leaves, basis, h, w, bg)
        g = torch.randn(img.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))

        def fwd():
            cuda_strokes.render_strokes_auto(*leaves, basis, h, w, bg)

        def bwd():
            torch.autograd.grad(img, leaves, g, retain_graph=True)

        out[label] = {}
        for name, fn, kernel in (("fwd", fwd, "strokes_fwd_kernel"), ("bwd", bwd, "strokes_bwd_kernel")):
            times = cs.kernel_times(fn)
            out[label][name] = {"kernel_ms": sum(ms for k, ms in times.items() if kernel in k),
                                "device_ms": sum(times.values()), "event_ms": cs.median_ms(fn)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose pixray_tpu_torch is measured")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default="pixel,clipdraw,vqgan,fft,image,anim,rn50,mixed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import pixray_tpu_torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.build_all()
    out = {"label": args.label, "package": os.path.dirname(pixray_tpu_torch.__file__), "card": card,
           "flagship_bank": flagship_bank(cs), "flagship_strokes": flagship_strokes(cs)}
    _install_markers()
    configs = {"pixel": cs.PIXEL_CONFIG, "clipdraw": cs.CLIPDRAW_CONFIG, "vqgan": cs.VQGAN_CONFIG,
               "fft": cs.FFT_CONFIG, "rn50": cs.RN50_CONFIG, "mixed": cs.MIXED_CONFIG}
    from pixray_tpu_torch.engine.core import Engine

    modes = (False, True) if hasattr(Engine, "_block_size") else (False,)  # a tree without blocks: eager only
    out["rows"] = []
    for row in filter(None, args.rows.split(",")):
        for blocked in modes:
            with tempfile.TemporaryDirectory() as tmp:
                if row == "image":
                    config = dict(cs.PIXEL_CONFIG, **cs.image_extra(cs.write_images(tmp)))
                elif row == "anim":
                    config = {**cs.PIXEL_CONFIG, **cs.anim_extra(tmp), "save_every": cs.PIXEL_CONFIG["save_every"]}
                else:
                    config = configs[row]
                out["rows"].append(profile_row(cs, row, config, tmp, blocked))
            torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"profile_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    for name, t in out["flagship_bank"].items():
        print(f"{args.label} flagship {name}: {t['device_ms']:.4f} ms of kernels, {t['event_ms']:.4f} ms "
              f"CUDA events; on {card}", flush=True)
    for scene, t in out["flagship_strokes"].items():
        print(f"{args.label} clipdraw strokes {scene}: render_strokes_auto forward {t['fwd']['kernel_ms']:.4f} ms "
              f"in K4s, {t['fwd']['device_ms']:.4f} ms of kernels, {t['fwd']['event_ms']:.4f} ms CUDA events; "
              f"backward {t['bwd']['kernel_ms']:.4f} ms in K5, {t['bwd']['device_ms']:.4f} ms of kernels, "
              f"{t['bwd']['event_ms']:.4f} ms CUDA events; on {card}", flush=True)
    for r in out["rows"]:
        if r["mode"] == "blocked":
            split = (f"step {r['step_ms']:.3f} ms walked in blocks of {r['blocks_per_walk']}, host dispatch "
                     f"{r['host_dispatch_ms']:.3f} ms per step; capture {r['capture_s']:.3f} s")
        else:
            split = (f"step {r['step_ms']:.3f} ms = draws {r['host_draws_ms']:.3f} + enqueue "
                     f"{r['host_enqueue_ms']:.3f} + device after host {r['device_after_host_ms']:.3f}")
        print(f"{args.label} {r['row']} {r['mode']}: {r['steps_per_s']:.3f} steps/s; {split}; "
              f"{r['kernels_per_step']:.1f} kernels ({r['device_events_per_step']:.1f} device events) per step, "
              f"device busy {r['device_busy_ms']:.3f} ms; cutouts {r['cutouts_device_ms']:.3f} ms in "
              f"{r['cutouts_kernels_per_step']:.1f} kernels; on {card}", flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
