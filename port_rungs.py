#!/usr/bin/env python3
"""Time the cutout bank's warp rungs (K1-int8, K1-bf16, K1-high and the
four K2 rungs) of one tree of the PyTorch port on one NVIDIA GPU.

    python3 port_rungs.py [--root DIR] [--label NAME] [--ladder] [--registers]

``--root`` imports ``pixray_tpu_torch`` from another checkout (default:
this one), so that two trees are measured in one call on one card, in
turns (parent, change, change, parent); the harness (this file and
``chip_smoke.py``'s timers, inputs and bounds) is always this checkout's,
and only interfaces that every tree with the precision rungs has are called
(``cuda_warp.launch_bank_fwd`` / ``launch_bank_bwd`` at a rung).

Banks: the flagship (64 cuts of 224 on the 224x224x3 work canvas, bf16,
47 jittered, noise; ``chip_smoke.flagship_bank_inputs``) and 64 cuts of
384 on 384x384x3, drawn alike.  Per bank, exact K1, K1-int8, K1-bf16
and K1-high (``save_pre``, as the step calls them; each call with the
passes it launches), and each K2 rung from the saved bank of the K1 rung that
selects it: the exact K2 from exact K1's, K2-bf16 and K2-int8 from
K1-int8's, K2-high from K1-high's; and each K2 rung once more on the bank
without jitter, whose cotangent is g itself.  Per call: the summed kernel
time of one call (``chip_smoke.kernel_times``), each kernel and fill by
name, and the median CUDA-event time of one call, beside chip_smoke.py's
bounds.

``--ladder`` drives chip_smoke.py 34's pixel row (17 steps, blocked,
ViT-B/32 on its seeded weights) at the exact rungs, with
``PIXRAY_TPU_WARP_PREC=bf16``, with ``=high`` and with ``=int8`` plus
``PIXRAY_TPU_WARP_BWD_PREC=int8``, and reads the device busy per step of
three replays of each.  ``--registers`` compiles the tree's
``csrc/warp.cu`` once more with its build's flags and ``-Xptxas -v`` and
records each kernel's registers and spill bytes as ptxas reports them.
Prints one JSON line and writes it to ``chiprun_out/rungs_<label>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
LADDER_ROWS = (("exact", {}), ("warp bf16", {"PIXRAY_TPU_WARP_PREC": "bf16"}),
               ("warp high", {"PIXRAY_TPU_WARP_PREC": "high"}),
               ("warp int8, K2 int8", {"PIXRAY_TPU_WARP_PREC": "int8", "PIXRAY_TPU_WARP_BWD_PREC": "int8"}))
K1_RUNGS = ("highest", "int8", "bf16", "high")
# K2's rungs, each from the saved bank of the K1 rung that selects it
K2_RUNGS = (("k2_exact", "highest", "highest"), ("k2_bf16", "int8", "bf16"), ("k2_int8", "int8", "int8"),
            ("k2_high", "high", "high"))
LADDER_WINDOWS = 3


def _times(cs, fn):
    """{"ms": summed kernel ms of one call, "kernels": {name: ms}, "event_ms": median CUDA-event ms}."""
    times = cs.kernel_times(fn)
    return {"ms": sum(times.values()), "kernels": times, "event_ms": cs.median_ms(fn)}


def bank(cs, n, s):
    """K1 at its four rungs and the four K2 rungs on one bank drawn as the flagship's."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3

    _, _, (work, ms, modes, jitter, facs, planes) = cs.flagship_bank_inputs(n, s)
    dev, bf16 = work.device, torch.bfloat16
    inv = inv3x3(ms.float())
    params = cuda_warp.pack_params(inv, modes, jitter, facs, fill=0.37)
    params_dev = params.to(dev)
    flat_dev = cuda_warp.pack_params(inv, modes, None, facs, fill=0.37).to(dev)
    shape = tuple(work.shape)
    g = torch.randn((n, 3, s, s), device=dev, generator=torch.Generator(device=dev).manual_seed(9)).to(bf16)
    jittered = int(jitter[2].sum())
    plane, rows, canvas = s * s * 2, params.numel() * 4, s * s * 3 * 4
    out = {
        "n": n, "s": s, "jittered": jittered,
        "k1_bound": cs.bound(canvas + rows + 3 * n * plane * 2 + 3 * jittered * plane,
                             (cs.WARP_FWD_FLOPS_PER_PIXEL * n + cs.JITTER_FWD_FLOPS_PER_PIXEL * jittered) * s * s),
        "k2_bound": cs.bound(3 * n * plane + 3 * jittered * plane + rows + canvas,
                             (cs.WARP_BWD_FLOPS_PER_PIXEL * n + cs.JITTER_BWD_FLOPS_PER_PIXEL * jittered) * s * s),
    }
    for prec in K1_RUNGS:
        out["k1_" + prec] = _times(cs, lambda prec=prec: cuda_warp.launch_bank_fwd(work, params_dev, s, planes, bf16,
                                                                                    save_pre=True, prec=prec))
    for key, fwd, bwd in K2_RUNGS:
        _, pre = cuda_warp.launch_bank_fwd(work, params_dev, s, planes, bf16, save_pre=True, prec=fwd)
        out[key] = _times(cs, lambda: cuda_warp.launch_bank_bwd(g, pre, params_dev, shape, s, prec=bwd))
        out[key + "_no_jitter"] = _times(cs, lambda: cuda_warp.launch_bank_bwd(g, None, flat_dev, shape, s, prec=bwd))
    return out


def registers():
    """{kernel<dtype>: [registers, spill store bytes, spill load bytes]} of
    the imported tree's ``csrc/warp.cu``, from ``nvcc -Xptxas -v``."""
    from pixray_tpu_torch.ops import nvcc

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, "w.so"),
                               nvcc.source_path("warp.cu")], capture_output=True, text=True, check=True)
    out, name, spills = {}, None, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+(bank_\w+?_kernel)(I13__nv_bfloat16|If)?", line)
        if m:
            name = m.group(1) + {"If": "<f32>", "I13__nv_bfloat16": "<bf16>"}.get(m.group(2), "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), *spills]
            name = None
    return out


def ladder(cs, tmp):
    """Device busy per step of chip_smoke.py 34's pixel row at LADDER_ROWS' rungs."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp

    sd = cs.vit_b32_weights()
    rows = {}
    for label, rungs in LADDER_ROWS:
        sub = os.path.join(tmp, label.replace(" ", "_"))
        os.makedirs(sub)
        with cs.rung_env(rungs):
            engine, losses, launches, _, elapsed, timed = cs.drive_path(
                dict(cs.PIXEL_CONFIG, iterations=cs.RUNG_STEPS), sub, cs.RUNG_STEPS, cs.WARMUP_STEPS,
                state_dicts={"ViT-B/32": sd})
        blk = engine.step_block
        busy = [cs.busy_ms(cs.profiled_events(blk.graph.replay, 1)) / blk.n for _ in range(LADDER_WINDOWS)]
        rows[label] = {"busy_ms": busy, "median_busy_ms": statistics.median(busy),
                       "last5": statistics.mean(losses[-5:]), "steps_per_s": timed / elapsed if timed else None,
                       "launches": {k: v for k, v in launches.items() if v and k in cuda_warp.LAUNCHES}}
        del engine
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose pixray_tpu_torch is measured")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--ladder", action="store_true", help="the pixel row's device busy at four warp rungs")
    ap.add_argument("--registers", action="store_true", help="each kernel's registers and spills (nvcc -Xptxas -v)")
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
           "banks": [bank(cs, 64, 224), bank(cs, 64, 384)]}
    if args.ladder:
        with tempfile.TemporaryDirectory() as tmp:
            out["ladder"] = ladder(cs, tmp)
    if args.registers:
        out["registers"] = registers()
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"rungs_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    for b in out["banks"]:
        t = lambda key: f"{b[key]['ms']:.4f} / {b[key]['event_ms']:.4f}"
        k2 = "; ".join(f"{key} {t(key)} ms, without jitter {t(key + '_no_jitter')} ms, kernels "
                       f"{json.dumps(b[key]['kernels'])}" for key, _, _ in K2_RUNGS)
        k1 = "; ".join(f"K1-{prec} {t('k1_' + prec)} ms, kernels {json.dumps(b['k1_' + prec]['kernels'])}"
                       for prec in K1_RUNGS)
        print(f"{args.label} bank {b['n']} cuts of {b['s']} ({b['jittered']} jittered): K1 bound "
              f"{b['k1_bound'][0]:.4f}: {k1}; K2 bound "
              f"{b['k2_bound'][0]:.4f}: {k2}; on {card}", flush=True)
    for kernel, (regs, stores, loads) in out.get("registers", {}).items():
        print(f"{args.label} {kernel}: {regs} registers, {stores} / {loads} bytes spill stores / loads", flush=True)
    for label, r in out.get("ladder", {}).items():
        print(f"{args.label} ladder {label}: busy per step {r['median_busy_ms']:.4f} ms "
              f"({[round(x, 4) for x in r['busy_ms']]}), last5 {r['last5']:.4f}, launches {r['launches']}; on {card}",
              flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
