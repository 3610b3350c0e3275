#!/usr/bin/env python3
"""Drive the PyTorch port (pixray_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA warp kernels from pixray_tpu_torch/csrc;
3. kernels vs their plain PyTorch versions on the card, forward and
   backward, at the flagship bank shapes (224x224x3 canvas, the 45
   perspective cuts of a 64-cut bank, S=224, modes 0/1/3 with a fill) and a
   ragged small case (N=5, S=17, 20x28 canvas), with median times;
4. agreement: a TinyTest run on the card against the same run on the CPU
   (plain warp), same draws, per-step losses compared;
5. main path: the bench's headline row (pixel drawer, 384x216, "sunrise",
   random-weight ViT-B/32, 64 cuts) through apply_settings + Engine, 9
   warm-up and 24 timed steps; asserts finite, descending losses, one K1 and
   one K2 launch per step, and the checkin PNG.

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
import time

# bench.py's _COMMON + CONFIGS["pixel"] (bench.py:76-95), restated here
# because bench.py drives the JAX package
PIXEL_CONFIG = dict(
    prompts="sunrise", clip_models="ViT-B/32", num_cuts=64, batches=1,
    save_every=100000, display_every=100000, init_noise=None, vector_prompts="none",
    seed=1, save_intermediates=False, learning_rate_drops=[],
    drawer="pixel", size=[384, 216],
)
WARMUP_STEPS = 9  # bench.py:73-74
TIMED_STEPS = 24

FWD_ATOL = 2e-4  # f32 coordinate rounding (FMA contraction) times a unit-range canvas
BWD_RTOL = 5e-4  # of max|dwork|: atomics sum in a run-dependent order
AGREE_ATOL = 2e-2  # per-step loss, card (bf16 epilogue) vs CPU (f32) on TinyTest


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


def _draws_to(draws, device, dtype):
    out = []
    for d in draws:
        ps = []
        for p in d["perceptors"]:
            facs, planes = p["noise"]
            ps.append(dict(p, noise=(facs.to(device, dtype), [z.to(device, dtype) for z in planes])))
        out.append(dict(d, perceptors=ps))
    return out


def phase_agreement(tmp):
    """TinyTest on the card vs on the CPU, same draws: per-step losses."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    cfg = dict(PIXEL_CONFIG, clip_models="TinyTest", size=[96, 54], num_cuts=8, iterations=10,
               precision="fp32", outdir=tmp)
    cpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cpu")
    gpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cuda")
    gpu.z = cpu.z.to("cuda")
    gpu.opt_state = gpu.optimizer.init(gpu.z)
    worst = 0.0
    for it in range(3):
        draws = cpu.draw_step()
        cpu.train(it, draws)
        gpu.train(it, _draws_to(draws, torch.device("cuda"), torch.bfloat16))
        a = cpu.last_loss_values.numpy()
        b = gpu.last_loss_values.float().cpu().numpy()
        worst = max(worst, float(abs(a - b).max()))
    print(f"agreement TinyTest card vs CPU, 3 steps: max |loss diff| {worst:.3g} (tol {AGREE_ATOL})",
          flush=True)
    if not worst <= AGREE_ATOL:
        fail(f"card run disagrees with the CPU run: {worst}")


def phase_main_path(tmp, card):
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.ops import cuda_warp

    steps = WARMUP_STEPS + TIMED_STEPS
    settings = apply_settings(dict(PIXEL_CONFIG, iterations=steps + 16, outdir=tmp),
                              apply_side_effects=False)
    t0 = time.perf_counter()
    engine = Engine(settings, device="cuda")
    init_s = time.perf_counter() - t0

    cuda_warp.reset_launch_counts()
    losses = []

    def step(it):
        engine.train(it)
        losses.append(float(engine.last_loss_values.float().sum()))

    for it in range(WARMUP_STEPS):
        step(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(WARMUP_STEPS, steps):
        step(it)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_warp.LAUNCHES)

    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite losses: {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < first5 - 0.005:
        fail(f"loss did not descend: first5={first5:.4f} last5={last5:.4f}")
    for name, count in launches.items():
        if count != steps:
            fail(f"{name} launched {count} times in {steps} steps")
    png = os.path.join(tmp, "output.png")
    if not (os.path.exists(png) and open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"):
        fail("checkin PNG missing")
    rate = TIMED_STEPS / elapsed
    print(f"main path: pixel 384x216, ViT-B/32 (random weights), 64 cuts: init {init_s:.1f} s, "
          f"{rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over {TIMED_STEPS} steps after "
          f"{WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"main path losses: first5 {first5:.4f} -> last5 {last5:.4f}; launches {launches}; "
          f"checkin {png}", flush=True)
    return launches


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

    from pixray_tpu_torch.ops import cuda_warp

    t0 = time.perf_counter()
    cuda_warp.build(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s ({cuda_warp.LIBRARY})", flush=True)

    flagship, small = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(tmp, card)

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
