#!/usr/bin/env python3
"""Capture one engine's CUDA graph while another thread steps a second
engine, under a given capture error mode.

    python3 port_capture_modes.py --mode thread_local
    python3 port_capture_modes.py --mode global

The HTTP front end (``pixray_tpu_torch/serve/http.py``) starts the next job
while a job abandoned past its deadline still steps until its next frame,
so the next job's capture can run beside it.  A runner thread here steps
the bench's pixel row eagerly with a host read of the loss each step (an
abandoned job's work); the main thread builds a second pixel engine and
runs 10 steps, capturing its first block.  Prints one JSON line: the mode,
what the capture and the runner raised (null: nothing), the runner's steps
during the capture, and the card.  Run one mode per process: a capture
that fails can leave the process's CUDA state unusable.
"""

import argparse
import json
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PIXEL = dict(prompts="sunrise", clip_models="ViT-B/32", num_cuts=64, batches=1, save_every=100000,
             display_every=100000, init_noise=None, vector_prompts="none", seed=1, save_intermediates=False,
             learning_rate_drops=[], drawer="pixel", size=[384, 216], iterations=10000)


def engine(outdir, **extra):
    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    return Engine(apply_settings(dict(PIXEL, outdir=outdir, **extra), apply_side_effects=False), device="cuda")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=["global", "thread_local", "relaxed"], required=True)
    mode = parser.parse_args().mode
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    graph_cls = torch.cuda.graph

    class Graph(graph_cls):  # the engine's capture, in the mode under test
        def __init__(self, cuda_graph, **kw):
            super().__init__(cuda_graph, **dict(kw, capture_error_mode=mode))

    torch.cuda.graph = Graph
    tmp = tempfile.mkdtemp()  # both engines' checkin PNGs
    out = {"mode": mode, "capture_error": None, "runner_error": None}
    stop, steps = threading.Event(), []

    def runner():
        try:
            eng = engine(tmp, steps_per_call=1)
            it = 0
            while not stop.is_set():
                eng.train(it)
                float(eng.last_loss_values.float().sum())
                steps.append(time.perf_counter())
                it += 1
        except Exception as exc:  # reported in the JSON line
            out["runner_error"] = f"{type(exc).__name__}: {exc}"[:400]

    thread = threading.Thread(target=runner, daemon=True)
    thread.start()
    while len(steps) < 5 and thread.is_alive():
        time.sleep(0.05)
    try:
        eng = engine(tmp)
        eng.train(0)
        t0 = time.perf_counter()
        for it in range(1, 10):
            eng.train(it)
            float(eng.last_loss_values.float().sum())
        t1 = time.perf_counter()
        out["blocks"] = eng.dispatched_blocks
        out["capture_s"] = eng.step_block.capture_s
        out["runner_steps_during_capture"] = sum(t0 <= t <= t0 + eng.step_block.capture_s for t in steps)
        out["runner_steps_during_the_blocked_steps"] = sum(t0 <= t <= t1 for t in steps)
    except Exception as exc:  # reported in the JSON line
        out["capture_error"] = f"{type(exc).__name__}: {exc}"[:400]
    stop.set()
    thread.join(60)
    shutil.rmtree(tmp, ignore_errors=True)
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
