#!/usr/bin/env python3
"""What ``chip_smoke.py`` 35's gates read on sound and on faulty sharding.

    python3 port_parallel_gates.py [--steps N] [--out FILE]

The pixel row of ``chip_smoke.py`` (384x216, random-weight ViT-B/32, 64
cuts) sharded on mesh (2, 1) over two gloo ranks that share the card,
against the same steps unsharded in this process, as 35 (a) runs it:

- sound, at the port's default precision and with f32 towers, each beside
  two unsharded runs' gap; with the latent gradient of every step, which
  elements part by more than 1e-3, and how large and of which sign their
  gradients were;
- two faults planted in a copy of the package (a temporary directory, the
  source edited by one string replacement each; this script runs again
  on that copy): ``stretch``, each chunk stretched by its own range
  instead of the whole bank's; ``same_chunk``, both ranks encoding chunk 0.

Prints one JSON line per run (``parallel_gates {...}``) with
``dryrun.agreement``'s three gaps, and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.environ.get("PORT_GATES_ROOT") or os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# fault → (file, the sound line, the faulty line)
FAULTS = {
    "stretch": ("pixray_tpu_torch/engine/step.py", "affine=spec.affine_fn(bank))",
                "affine=spec.affine_fn(M.shard_cutout_batch(bank, cfg.mesh)))"),
    "same_chunk": ("pixray_tpu_torch/parallel/mesh.py", "return batch.narrow(0, mesh.data_index * chunk, chunk)",
                   "return batch.narrow(0, 0, chunk)"),
}
GRADS: list = []  # this process's latent gradients, one per step


def record_grads():
    """Wrap the step's gradient function so that each step's (summed)
    latent gradient lands in GRADS, flat in the latent's leaf order."""
    import torch

    from pixray_tpu_torch.engine import step
    from pixray_tpu_torch.engine.latent import leaves

    if getattr(step.inputs_loss_and_grads, "recording", False):
        return
    inner = step.inputs_loss_and_grads

    def recording(cfg, z, inputs):
        grads, first = inner(cfg, z, inputs)
        GRADS.append(torch.cat([g.detach().float().reshape(-1) for g in leaves(grads)]).cpu().numpy())
        return grads, first

    recording.recording = True
    step.inputs_loss_and_grads = recording


def sharded_rank(config: dict, steps: int, shape: str) -> dict:
    """A rank's run (spawned by ``dryrun.launch``), with its gradients."""
    import pixray_tpu_torch
    from pixray_tpu_torch.parallel import dryrun

    assert pixray_tpu_torch.__file__.startswith(ROOT), pixray_tpu_torch.__file__
    record_grads()
    GRADS.clear()
    out = dryrun.run_config(config, steps, "cuda", shape)
    out["grads"] = list(GRADS)
    return out


def gradient_report(dz, sharded: list, base: list) -> dict:
    """The parted elements (|dz| > 1e-3): their count, the sign changes of
    the gradient per step over the whole latent, |g|'s quantiles at step
    0, and for the five that part most their gradients per step and where
    each |g| falls among all elements' (its quantile)."""
    parted = np.flatnonzero(np.abs(dz) > 1e-3)
    top = parted[np.argsort(-np.abs(dz[parted]))][:5]
    return {
        "sign_changes_per_step": [int(np.sum(np.sign(a) != np.sign(b))) for a, b in zip(sharded, base)],
        "abs_g_step0_quantiles_0.1_1_10_50_90pct": [float(q) for q in np.quantile(np.abs(base[0]),
                                                                                  [0.001, 0.01, 0.1, 0.5, 0.9])],
        "most_parted": [{"element": int(i), "dz": float(dz[i]), "g_sharded": [float(g[i]) for g in sharded],
                         "g_unsharded": [float(g[i]) for g in base],
                         "abs_g_quantile": [float(np.mean(np.abs(g) <= abs(g[i]))) for g in base]} for i in top],
    }


def measure(label: str, steps: int, out_path: str) -> None:
    import torch

    import chip_smoke as cs
    from pixray_tpu_torch.parallel import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build_all()
    record_grads()
    configs = [("default", cs.PIXEL_CONFIG)]
    if label == "sound":
        configs.append(("fp32 towers", dict(cs.PIXEL_CONFIG, precision="fp32")))
    for name, config in configs:
        t0 = time.perf_counter()
        ranks = dryrun.launch(sharded_rank, 2, config, steps, "2,1", deadline=300.0, threads=2)
        GRADS.clear()
        base = dryrun.run_config(config, steps, "cuda")
        base_grads = list(GRADS)
        pair = dryrun.agreement(dryrun.run_config(config, steps, "cuda"), base)
        dz = ranks[0]["z"] - base["z"]
        rec = {"run": label, "precision": name, "steps": steps, "card": cs.card_line(),
               "sharded": dryrun.agreement(ranks[0], base), "two_unsharded": pair,
               "parted_over_1e-3": int(np.sum(np.abs(dz) > 1e-3)), "numel": int(dz.size),
               "ranks_bitwise": ranks[0]["z"].tobytes() == ranks[1]["z"].tobytes(),
               "losses": ranks[0]["losses"], "unsharded_losses": base["losses"], "s": time.perf_counter() - t0}
        if label == "sound":
            rec["gradients"] = gradient_report(dz, ranks[0]["grads"], base_grads)
        line = json.dumps(rec)
        print(f"parallel_gates {line}", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")


def planted(fault: str, steps: int, out_path: str) -> None:
    """This script on a copy of the package with ``fault`` planted."""
    path, sound, faulty = FAULTS[fault]
    with tempfile.TemporaryDirectory() as copy:
        for name in ("pixray_tpu_torch", "chip_smoke.py", os.path.basename(__file__)):
            src = os.path.join(ROOT, name)
            (shutil.copytree if os.path.isdir(src) else shutil.copy2)(src, os.path.join(copy, name))
        target = os.path.join(copy, path)
        with open(target) as f:
            text = f.read()
        if text.count(sound) != 1:
            raise SystemExit(f"fault {fault}: {sound!r} occurs {text.count(sound)} times in {path}")
        with open(target, "w") as f:
            f.write(text.replace(sound, faulty))
        subprocess.run([sys.executable, os.path.join(copy, os.path.basename(__file__)), "--run", fault,
                        "--steps", str(steps), "--out", os.path.abspath(out_path)],
                       env=dict(os.environ, PORT_GATES_ROOT=copy), cwd=copy, check=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)  # chip_smoke.PARALLEL_STEPS
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "parallel_gates.jsonl"))
    parser.add_argument("--run", default=None, help=argparse.SUPPRESS)  # set on a copy with a fault planted
    opts = parser.parse_args()
    if opts.run is not None:
        measure(opts.run, opts.steps, opts.out)
        return
    measure("sound", opts.steps, opts.out)
    for fault in FAULTS:
        planted(fault, opts.steps, opts.out)


if __name__ == "__main__":
    main()
