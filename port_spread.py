#!/usr/bin/env python3
"""How far runs of the PyTorch port part on one NVIDIA GPU from one state.

    python3 port_spread.py [--optimisers Adam,Adamax,...] [--trials N] [--steps N]

For each optimiser, N times: the pixel row of ``chip_smoke.py`` (384x216,
random-weight ViT-B/32, 64 cuts) as two blocked engines (``--steps_per_call
8``) and four eager ones (1), every engine's step 0 eager, then the blocked
engine's latent and optimizer state copied into the others, so that all six
start step 1 from one state with the same draws.  After ``--steps`` steps it
prints, for each pair of runs, the largest per-step loss gap, the step where
it falls and every step's gap, and the latent's largest gap.  The runs part
only by the order of K2's float atomics: the gaps between two eager runs are
the scale a blocked run's can be judged by (``PERF.md`` §6).
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402


def trial(optimiser: str, steps: int) -> list[str]:
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.engine.optimizers import state_tensors

    with tempfile.TemporaryDirectory() as tmp:
        cfg = dict(cs.PIXEL_CONFIG, optimiser=optimiser, iterations=steps + 1, outdir=tmp)
        names = ["B0", "B1", "E2", "E3", "E4", "E5"]
        runs = [Engine(apply_settings(dict(cfg, steps_per_call=8 if n[0] == "B" else 1), apply_side_effects=False),
                       device="cuda") for n in names]
        for e in runs:
            e.train(0)
        with torch.no_grad():
            for e in runs[1:]:
                for dst, src in zip(leaves(e.z) + state_tensors(e.opt_state),
                                    leaves(runs[0].z) + state_tensors(runs[0].opt_state)):
                    dst.copy_(src)
        losses = []
        for e in runs:
            per_step = []
            for it in range(1, steps + 1):
                e.train(it)
                per_step.append(e.last_loss_values.float().cpu())
            losses.append(torch.stack(per_step))
        torch.cuda.synchronize()
        zs = [torch.cat([t.float().flatten() for t in leaves(e.z)]).cpu() for e in runs]
        out = []
        for i, j in itertools.combinations(range(len(runs)), 2):
            gap = (losses[i] - losses[j]).abs().amax(dim=1)
            out.append(f"{names[i]}-{names[j]}: max {float(gap.max()):.3g} at step {int(gap.argmax()) + 1}; per step "
                       f"{[float(f'{x:.2g}') for x in gap]}; latent max {float((zs[i] - zs[j]).abs().max()):.3g}")
        return out


def main():
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--optimisers", default="Adam,Adamax,Adagrad")
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--steps", type=int, default=cs.BLOCKED_STEPS)
    a = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.build_all()
    for optimiser, n in itertools.product(a.optimisers.split(","), range(a.trials)):
        t0 = time.perf_counter()
        lines = trial(optimiser, a.steps)
        print(f"== {optimiser} trial {n} ({time.perf_counter() - t0:.1f} s) on {card}", flush=True)
        for line in lines:
            print(line, flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
