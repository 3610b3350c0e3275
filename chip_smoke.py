#!/usr/bin/env python3
"""Drive the PyTorch port (pixray_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA sources of pixray_tpu_torch/csrc (warp.cu and
   strokes.cu, one nvcc each, in parallel);
3. warp kernels (K1, K2) vs their plain PyTorch versions on the card,
   forward and backward, at the flagship bank shapes (224x224x3 canvas, the
   45 perspective cuts of a 64-cut bank, S=224, modes 0/1/3 with a fill) and
   a ragged small case (N=5, S=17, 20x28 canvas), with median times;
4. stroke kernels (K4, K4s, K5) vs the plain stroke renderer on the card,
   forward, chunk prefixes and all four gradients: clipdraw's own init
   (1024 strokes, P=25, 384x216, white), line_sketch (24 strokes, P=65,
   paper background) and a ragged case (9 strokes on 40x140: off-canvas,
   zero-length, exact-tie and alpha-0 strokes), with median times;
5. agreement: TinyTest pixel and clipdraw runs on the card against the same
   runs on the CPU (plain versions), same latent and draws, per-step losses;
6. main path: the bench's headline row (pixel drawer, 384x216, "sunrise",
   random-weight ViT-B/32, 64 cuts) through apply_settings + Engine, 9
   warm-up and 24 timed steps; asserts finite, descending losses, one K1 and
   one K2 launch per step, and the checkin PNG;
7. clipdraw path: the bench's clipdraw row (1024 strokes, same prompt,
   model, cuts and canvas), 9 + 24 steps; asserts finite, descending losses,
   one K4s + K5 + K1 + K2 launch per step, K4 at checkin, the PNG and the
   SVG of --save_svg;
8. line_sketch: a few steps with a trainable paper color; asserts finite
   losses, launches, and that the paper color moved.

Then one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# bench.py's _COMMON + CONFIGS["pixel"] (bench.py:76-95), restated here
# because bench.py drives the JAX package
PIXEL_CONFIG = dict(
    prompts="sunrise", clip_models="ViT-B/32", num_cuts=64, batches=1,
    save_every=100000, display_every=100000, init_noise=None, vector_prompts="none",
    seed=1, save_intermediates=False, learning_rate_drops=[],
    drawer="pixel", size=[384, 216],
)
CLIPDRAW_CONFIG = dict(PIXEL_CONFIG, drawer="clipdraw")  # CONFIGS["clipdraw"], bench.py:105
WARMUP_STEPS = 9  # bench.py:73-74
TIMED_STEPS = 24
LINE_SKETCH_STEPS = 4

FWD_ATOL = 2e-4  # f32 coordinate rounding (FMA contraction) times a unit-range canvas
BWD_RTOL = 5e-4  # of max|dwork|: atomics sum in a run-dependent order
AGREE_ATOL = 2e-2  # per-step loss, card (bf16 epilogue) vs CPU (f32) on TinyTest
STROKE_FWD_ATOL = 1e-4  # the JAX fused-vs-XLA forward tolerance (tests/test_pallas_strokes.py:38)


def fail(msg: str):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_all():
    """One nvcc per CUDA source, started together; returns seconds per library."""
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    times, errors = {}, {}

    def one(mod):
        t0 = time.perf_counter()
        try:
            mod.build(force=True)
        except Exception as exc:  # reported below, fatal
            errors[mod.LIBRARY] = exc
        times[mod.LIBRARY] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(m,)) for m in (cuda_warp, cuda_strokes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build failed: {errors}")
    return times


def median_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_case(work, ms, modes, fill, out_size, time_it):
    """K1/K2 vs the plain version on one bank; returns the numbers."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3
    from pixray_tpu_torch.ops.warp_batch import warp_modes_plain

    dev = work.device
    inv = inv3x3(ms.float()).to(dev).contiguous()
    modes = modes.to(dev, torch.int32).contiguous()
    n, c = ms.shape[0], work.shape[2]

    out_k = cuda_warp.launch_fwd(work, inv, modes, fill, out_size)
    out_p = warp_modes_plain(work, inv, modes, fill, out_size)
    torch.cuda.synchronize()
    if out_k.shape != (n, c, out_size, out_size) or not torch.isfinite(out_k).all():
        fail(f"K1 output malformed: {tuple(out_k.shape)}")
    fwd_err = float((out_k - out_p).abs().max())

    g = torch.randn((n, c, out_size, out_size), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    dwork_k = cuda_warp.launch_bwd(g, inv, modes, tuple(work.shape), out_size)
    w_req = work.clone().requires_grad_(True)
    (dwork_p,) = torch.autograd.grad(warp_modes_plain(w_req, inv, modes, fill, out_size), w_req, g)
    torch.cuda.synchronize()
    bwd_err = float((dwork_k - dwork_p).abs().max())
    bwd_tol = BWD_RTOL * max(float(dwork_p.abs().max()), 1e-6)
    res = {"n": n, "s": out_size, "canvas": list(work.shape), "fwd_err": fwd_err,
           "bwd_err": bwd_err, "bwd_tol": bwd_tol}
    if not fwd_err <= FWD_ATOL:
        fail(f"K1 disagrees with the plain warp: {res}")
    if not bwd_err <= bwd_tol:
        fail(f"K2 disagrees with the plain adjoint: {res}")
    if time_it:
        # the plain backward alone: autograd through a forward taken once
        w_plain = work.clone().requires_grad_(True)
        out_plain = warp_modes_plain(w_plain, inv, modes, fill, out_size)

        def plain_bwd():
            torch.autograd.grad(out_plain, w_plain, g, retain_graph=True)

        res.update(
            fwd_ms=median_ms(lambda: cuda_warp.launch_fwd(work, inv, modes, fill, out_size)),
            fwd_plain_ms=median_ms(lambda: warp_modes_plain(work, inv, modes, fill, out_size)),
            bwd_ms=median_ms(lambda: cuda_warp.launch_bwd(g, inv, modes, tuple(work.shape), out_size)),
            bwd_plain_ms=median_ms(plain_bwd),
        )
    return res


def phase_kernels():
    import torch

    from pixray_tpu_torch.engine.cutouts import cut_transforms, draw_cut_params, persp_split

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    # flagship: the perspective cuts of a 64-cut bank on the 384x216 canvas
    aspect = 384 / 216
    zoom, wide = cut_transforms(draw_cut_params(gen, 64, aspect), 224, aspect)
    nzp, nwp = persp_split(zoom.shape[0])[0], persp_split(wide.shape[0])[0]
    ms = torch.cat([zoom[:nzp], wide[:nwp]])
    modes = torch.tensor([i % 2 for i in range(nzp)] + [3] * nwp, dtype=torch.int32)
    work = torch.rand((224, 224, 3), generator=gen).to(dev)
    flagship = kernel_case(work, ms, modes, 0.37, 224, time_it=True)
    print(f"kernels flagship (N={ms.shape[0]}, S=224, 224x224x3): "
          f"K1 max_abs_err {flagship['fwd_err']:.3g} (tol {FWD_ATOL}), "
          f"K2 max_abs_err {flagship['bwd_err']:.3g} (tol {flagship['bwd_tol']:.3g}); "
          f"fwd {flagship['fwd_ms']:.4f} ms vs plain {flagship['fwd_plain_ms']:.4f} ms, "
          f"bwd {flagship['bwd_ms']:.4f} ms vs plain {flagship['bwd_plain_ms']:.4f} ms", flush=True)

    zoom, wide = cut_transforms(draw_cut_params(gen, 8, 28 / 20), 17, 28 / 20)
    ms_small = torch.cat([zoom[:3], wide[:2]])
    modes_small = torch.tensor([0, 1, 2, 3, 3], dtype=torch.int32)
    work_small = torch.rand((20, 28, 3), generator=gen).to(dev)
    small = kernel_case(work_small, ms_small, modes_small, 0.6, 17, time_it=False)
    print(f"kernels ragged (N=5, S=17, 20x28x3): K1 max_abs_err {small['fwd_err']:.3g}, "
          f"K2 max_abs_err {small['bwd_err']:.3g} (tol {small['bwd_tol']:.3g})", flush=True)
    return flagship, small


def stroke_case(name, samples, widths, colors, background, time_it):
    """K4, K4s, K5 vs the plain renderer on one scene: forward, chunk
    prefixes, and the gradients w.r.t. samples, widths, colors and the
    premultiplied background for a seeded cotangent."""
    import torch

    from pixray_tpu_torch.ops import cuda_strokes
    from pixray_tpu_torch.ops.strokes import composite_premult, premultiply

    dev = samples.device
    bg_hwc = premultiply(background).contiguous()
    bg = bg_hwc.permute(2, 0, 1).contiguous()
    meta = cuda_strokes.pack_meta(samples, widths, colors)

    out4 = cuda_strokes.launch_fwd(samples, meta, bg)
    out4s, prefixes = cuda_strokes.launch_fwd(samples, meta, bg, store=True)
    plain_prefixes = []
    with torch.no_grad():
        plain = composite_premult(samples, widths, colors, bg_hwc, prefixes=plain_prefixes)
    torch.cuda.synchronize()
    plain = plain.permute(2, 0, 1)
    if out4.shape != plain.shape or not torch.isfinite(out4).all():
        fail(f"K4 output malformed on {name}: {tuple(out4.shape)}")
    fwd_err = float((out4 - plain).abs().max())
    store_err = max([float((out4s - plain).abs().max())] + [
        float((k - p.permute(2, 0, 1)).abs().max()) for k, p in zip(prefixes, plain_prefixes)])
    if len(plain_prefixes) != prefixes.shape[0]:
        fail(f"K4s stored {prefixes.shape[0]} prefixes, the plain version {len(plain_prefixes)}")

    g = torch.randn(tuple(bg.shape), device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    dsamples, dmeta, dbg = cuda_strokes.launch_bwd(g, samples, meta, prefixes)
    leaves = [t.clone().requires_grad_(True) for t in (samples, widths, colors, bg_hwc)]
    out_plain = composite_premult(*leaves)
    plain_grads = torch.autograd.grad(out_plain, leaves, g.permute(1, 2, 0), retain_graph=time_it)
    torch.cuda.synchronize()
    res = {"name": name, "n": int(samples.shape[0]), "p": int(samples.shape[1]),
           "canvas": list(bg.shape[1:]), "fwd_err": fwd_err, "store_err": store_err}
    kernel_grads = (dsamples, dmeta[:, 0], dmeta[:, 1:5], dbg.permute(1, 2, 0))
    bwd = {}
    for gname, k, p in zip(("samples", "widths", "colors", "bg"), kernel_grads, plain_grads):
        err = float((k - p).abs().max())
        tol = BWD_RTOL * max(float(p.abs().max()), 1e-6)
        bwd[gname] = (err, tol)
        if not err <= tol:
            fail(f"K5 d{gname} disagrees with the plain gradient on {name}: {err} > {tol}; {res}")
    res["bwd"] = bwd
    res["bwd_err"] = max(e for e, _ in bwd.values())
    if not fwd_err <= STROKE_FWD_ATOL:
        fail(f"K4 disagrees with the plain renderer on {name}: {res}")
    if not store_err <= STROKE_FWD_ATOL:
        fail(f"K4s disagrees with the plain renderer on {name}: {res}")
    if time_it:
        def plain_fwd():
            with torch.no_grad():
                composite_premult(samples, widths, colors, bg_hwc, prefixes=[])

        def plain_bwd():
            torch.autograd.grad(out_plain, leaves, g.permute(1, 2, 0), retain_graph=True)

        res.update(
            fwd_ms=median_ms(lambda: cuda_strokes.launch_fwd(samples, meta, bg)),
            store_ms=median_ms(lambda: cuda_strokes.launch_fwd(samples, meta, bg, store=True)),
            bwd_ms=median_ms(lambda: cuda_strokes.launch_bwd(g, samples, meta, prefixes)),
            fwd_plain_ms=median_ms(plain_fwd, reps=5),
            bwd_plain_ms=median_ms(plain_bwd, reps=5),
        )
    return res


def _drawer_scene(drawer_cls, settings, seed, background):
    """A drawer's own init, sampled into polylines on the card."""
    import torch

    from pixray_tpu_torch.ops.strokes import sample_paths

    drawer = drawer_cls(settings)
    drawer.snap_canvas(settings.size)
    z = drawer.init_params(torch.Generator().manual_seed(seed))
    dev = torch.device("cuda")
    samples = sample_paths(drawer.model_params["basis"].to(dev), z["points"].to(dev)).contiguous()
    n = samples.shape[0]
    colors = z["colors"].to(dev) if "colors" in z else torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
    return samples, z["widths"].to(dev), colors, background.to(dev)


def _ragged_scene():
    """9 strokes on 40x140 (one partial chunk): one off-canvas, one
    zero-length, two 1-segment strokes with a repeated-endpoint tail (exact
    ties), one with alpha 0, four random; samples built exactly."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    h, w, p = 40, 140, 17
    t = np.linspace(0.0, 1.0, 9)[:, None]

    def cubic_with_tail(c):
        s = ((1 - t) ** 3 * c[0] + 3 * t * (1 - t) ** 2 * c[1] + 3 * t ** 2 * (1 - t) * c[2] + t ** 3 * c[3])
        return np.concatenate([s, np.repeat(s[-1:], p - len(s), 0)])

    strokes = [np.full((p, 2), -500.0), np.tile([70.0, 20.0], (p, 1))]
    strokes += [cubic_with_tail(rng.uniform([0, 0], [w, h], (4, 2))) for _ in range(2)]
    strokes += [np.linspace([30.0, 8.0], [110.0, 30.0], p)]
    strokes += [np.cumsum(rng.uniform(-6, 6, (p, 2)), 0) + rng.uniform([10, 5], [w - 10, h - 5]) for _ in range(4)]
    samples = np.stack(strokes).astype(np.float32)
    widths = rng.uniform(1.0, 8.0, len(strokes)).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (len(strokes), 4)).astype(np.float32)
    colors[4, 3] = 0.0
    bg = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    dev = torch.device("cuda")
    return tuple(torch.tensor(a, device=dev) for a in (samples, widths, colors, bg))


def phase_stroke_kernels():
    from types import SimpleNamespace

    import torch

    from pixray_tpu_torch.drawers.clipdraw import ClipDrawer
    from pixray_tpu_torch.drawers.line_sketch import PAPER_COLOR, LineDrawer

    w, h = CLIPDRAW_CONFIG["size"]
    clip_settings = SimpleNamespace(size=[w, h], strokes=1024, min_stroke_width=1, max_stroke_width=5)
    flagship = stroke_case("clipdraw", *_drawer_scene(ClipDrawer, clip_settings, 0, torch.ones((h, w, 3))),
                           time_it=True)
    line_settings = SimpleNamespace(size=[w, h], strokes=24, stroke_length=8, min_stroke_width=0.5,
                                    max_stroke_width=2, allow_paper_color=True)
    paper = torch.tensor(PAPER_COLOR).expand(h, w, 3)
    line = stroke_case("line_sketch", *_drawer_scene(LineDrawer, line_settings, 1, paper), time_it=False)
    ragged = stroke_case("ragged", *_ragged_scene(), time_it=False)
    for r in (flagship, line, ragged):
        grads = ", ".join(f"d{k} {e:.3g} (tol {t:.3g})" for k, (e, t) in r["bwd"].items())
        print(f"stroke kernels {r['name']} (N={r['n']}, P={r['p']}, {r['canvas'][0]}x{r['canvas'][1]}): "
              f"K4 max_abs_err {r['fwd_err']:.3g}, K4s {r['store_err']:.3g} (tol {STROKE_FWD_ATOL}); "
              f"K5 {grads}", flush=True)
    print(f"stroke kernels clipdraw flagship times: K4 {flagship['fwd_ms']:.4f} ms, "
          f"K4s {flagship['store_ms']:.4f} ms vs plain forward {flagship['fwd_plain_ms']:.4f} ms; "
          f"K5 {flagship['bwd_ms']:.4f} ms vs plain backward {flagship['bwd_plain_ms']:.4f} ms", flush=True)
    return flagship, line, ragged



def _draws_to(draws, device, dtype):
    out = []
    for d in draws:
        ps = []
        for p in d["perceptors"]:
            facs, planes = p["noise"]
            ps.append(dict(p, noise=(facs.to(device, dtype), [z.to(device, dtype) for z in planes])))
        out.append(dict(d, perceptors=ps))
    return out


def phase_agreement(tmp, drawer_config, label, **extra):
    """TinyTest on the card vs on the CPU, same latent and draws: per-step losses."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import tree_map

    cfg = dict(drawer_config, clip_models="TinyTest", size=[96, 54], num_cuts=8, iterations=10,
               precision="fp32", outdir=tmp, **extra)
    cpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cpu")
    gpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cuda")
    gpu.z = tree_map(lambda t: t.to("cuda"), cpu.z)
    gpu.opt_state = gpu.optimizer.init(gpu.z)
    for k, v in cpu.drawer_params.items():
        gpu.drawer_params[k] = v.to("cuda")
    worst = 0.0
    for it in range(3):
        draws = cpu.draw_step()
        cpu.train(it, draws)
        gpu.train(it, _draws_to(draws, torch.device("cuda"), torch.bfloat16))
        a = cpu.last_loss_values.numpy()
        b = gpu.last_loss_values.float().cpu().numpy()
        worst = max(worst, float(abs(a - b).max()))
    print(f"agreement TinyTest {label} card vs CPU, 3 steps: max |loss diff| {worst:.3g} (tol {AGREE_ATOL})",
          flush=True)
    if not worst <= AGREE_ATOL:
        fail(f"{label} card run disagrees with the CPU run: {worst}")


def drive_path(config, tmp, steps, warmup):
    """An Engine on the card, stepped ``steps`` times with a host read of the
    loss after each (as bench.py reads it); every launch counter is set to 0
    just before the steps and read just after.  Returns (engine, losses,
    launches, init seconds, seconds of the steps after ``warmup``)."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    settings = apply_settings(dict(config, outdir=tmp), apply_side_effects=False)
    t0 = time.perf_counter()
    engine = Engine(settings, device="cuda")
    init_s = time.perf_counter() - t0

    cuda_warp.reset_launch_counts()
    cuda_strokes.reset_launch_counts()
    losses = []
    for it in range(steps):
        if it == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        engine.train(it)
        losses.append(float(engine.last_loss_values.float().sum()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite losses: {losses}")
    return engine, losses, launches, init_s, elapsed


def check_descent(label, losses):
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < first5 - 0.005:
        fail(f"{label}: loss did not descend: first5={first5:.4f} last5={last5:.4f}")
    return first5, last5


def check_launches(label, launches, expected):
    for name, want in expected.items():
        got = launches[name]
        if not (got >= 1 if want == "some" else got == want):
            fail(f"{label}: {name} launched {got} times, expected {want}; {launches}")


def check_png(label, path):
    if not (os.path.exists(path) and open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"):
        fail(f"{label}: checkin PNG missing")


def phase_main_path(tmp, card):
    steps = WARMUP_STEPS + TIMED_STEPS
    _, losses, launches, init_s, elapsed = drive_path(dict(PIXEL_CONFIG, iterations=steps + 16), tmp,
                                                      steps, WARMUP_STEPS)
    first5, last5 = check_descent("pixel", losses)
    check_launches("pixel", launches, {"warp_fwd": steps, "warp_bwd": steps, "strokes_fwd": 0,
                                       "strokes_fwd_store": 0, "strokes_bwd": 0})
    png = os.path.join(tmp, "output.png")
    check_png("pixel", png)
    rate = TIMED_STEPS / elapsed
    print(f"main path: pixel 384x216, ViT-B/32 (random weights), 64 cuts: init {init_s:.1f} s, "
          f"{rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over {TIMED_STEPS} steps after "
          f"{WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"main path losses: first5 {first5:.4f} -> last5 {last5:.4f}; launches {launches}; "
          f"checkin {png}", flush=True)
    return launches


def phase_clipdraw_path(tmp, card):
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed = drive_path(
        dict(CLIPDRAW_CONFIG, iterations=steps, save_svg=True), tmp, steps, WARMUP_STEPS)
    first5, last5 = check_descent("clipdraw", losses)
    check_launches("clipdraw", launches, {"warp_fwd": steps, "warp_bwd": steps, "strokes_fwd_store": steps,
                                          "strokes_bwd": steps, "strokes_fwd": "some"})
    png = os.path.join(tmp, "output.png")
    check_png("clipdraw", png)
    engine.cur_iteration = steps
    engine.run()  # the final checkin, then --save_svg
    svg = os.path.join(tmp, "output.svg")
    if not (os.path.exists(svg) and open(svg).read().count("<path ") == 1024):
        fail("clipdraw: the SVG of --save_svg is missing or incomplete")
    rate = TIMED_STEPS / elapsed
    print(f"clipdraw path: 1024 strokes, 384x216, ViT-B/32 (random weights), 64 cuts: init {init_s:.1f} s, "
          f"{rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over {TIMED_STEPS} steps after "
          f"{WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"clipdraw losses: first5 {first5:.4f} -> last5 {last5:.4f}; launches {launches}; "
          f"checkin {png}; svg {svg}", flush=True)
    return launches


def phase_line_sketch(tmp):
    import torch

    from pixray_tpu_torch.drawers.line_sketch import PAPER_COLOR

    config = dict(PIXEL_CONFIG, drawer="line_sketch", allow_paper_color=True, iterations=LINE_SKETCH_STEPS + 16)
    engine, losses, launches, _, _ = drive_path(config, tmp, LINE_SKETCH_STEPS, 0)
    check_launches("line_sketch", launches, {
        "warp_fwd": LINE_SKETCH_STEPS, "warp_bwd": LINE_SKETCH_STEPS, "strokes_fwd_store": LINE_SKETCH_STEPS,
        "strokes_bwd": LINE_SKETCH_STEPS, "strokes_fwd": "some"})
    moved = float((engine.z["paper"].cpu() - torch.tensor(PAPER_COLOR)).abs().max())
    if not moved > 0:
        fail("line_sketch: the trainable paper color did not move")
    print(f"line_sketch: 24 strokes x 8 segments (P=65), trainable paper, {LINE_SKETCH_STEPS} steps: "
          f"losses {[round(v, 4) for v in losses]}, paper moved {moved:.3g}; launches {launches}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    for lib, secs in build_all().items():
        print(f"build: {secs:.1f} s ({lib})", flush=True)

    flagship, small = phase_kernels()
    strokes = phase_stroke_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, PIXEL_CONFIG, "pixel")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, CLIPDRAW_CONFIG, "clipdraw", strokes=16)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(tmp, card)
    with tempfile.TemporaryDirectory() as tmp:
        stroke_launches = phase_clipdraw_path(tmp, card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_line_sketch(tmp)

    replaces = "pixray_tpu/ops/pallas_warp.py:{}"
    kernels = [
        {"name": "warp_modes_fwd (K1)", "route": "cuda", "source": "pixray_tpu_torch/csrc/warp.cu",
         "replaces": replaces.format(549), "launches": launches["warp_fwd"],
         "max_abs_err": max(flagship["fwd_err"], small["fwd_err"]),
         "ms": flagship["fwd_ms"], "plain_ms": flagship["fwd_plain_ms"]},
        {"name": "warp_modes_bwd (K2)", "route": "cuda", "source": "pixray_tpu_torch/csrc/warp.cu",
         "replaces": replaces.format(693), "launches": launches["warp_bwd"],
         "max_abs_err": max(flagship["bwd_err"], small["bwd_err"]),
         "ms": flagship["bwd_ms"], "plain_ms": flagship["bwd_plain_ms"]},
    ]
    stroke_src = "pixray_tpu_torch/csrc/strokes.cu"
    replaces = "pixray_tpu/ops/pallas_strokes.py:{}"
    for name, line, counter, err, ms, plain in (
            ("strokes_fwd (K4)", 116, "strokes_fwd", "fwd_err", "fwd_ms", "fwd_plain_ms"),
            ("strokes_fwd_store (K4s)", 132, "strokes_fwd_store", "store_err", "store_ms", "fwd_plain_ms"),
            ("strokes_bwd (K5)", 151, "strokes_bwd", "bwd_err", "bwd_ms", "bwd_plain_ms")):
        kernels.append({"name": name, "route": "cuda", "source": stroke_src, "replaces": replaces.format(line),
                        "launches": stroke_launches[counter], "max_abs_err": max(r[err] for r in strokes),
                        "ms": strokes[0][ms], "plain_ms": strokes[0][plain]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
