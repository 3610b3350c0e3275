"""One run of one cell: the program measured, then judged against the
reference, then each metric read.  Returns the result line's object and the
lines that show each compared number beside its limit."""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass

import torch

from portbench.harness import cell as C
from portbench.harness import drive, judge
from portbench.harness import weights as W
from portbench.reference import step as R


@dataclass
class RunContext:
    """What a metric's reader reads: the cell, the reference settings, the
    program's run (host clock, counters) and the traced walk's summary."""

    cell: C.Cell
    settings: dict
    prog: drive.ProgramRun

    @property
    def trace(self):
        return self.prog.trace


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def reference(cell: C.Cell, settings: dict, weights: dict, seed: int, device, prog) -> dict:
    """The reference's side of the judge for the program's run ``prog``:
    the first steps followed from the seed (or from the program's initial
    latent, whose init is then checked by itself) and step 0's render."""
    from_program = C.start(cell) == "program"
    ref = R.follow(settings, weights, seed, device, prog.followed_steps, z0=prog.z0 if from_program else None)
    ref["image"] = R.render(settings, weights, prog.z1, device)
    if from_program and prog.init_image is not None:  # without one, the init's numbers are missing and fail
        ref.update(R.init_check(settings, weights, prog.init_image, prog.init_pre, prog.z0, device))
    return ref


def measure(cell: C.Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    device = torch.device(device)
    prog = drive.run(cell, seed, seconds, trace, device, t_start)
    outdir = prog.engine.args.outdir
    drive.release(prog)
    shutil.rmtree(outdir, ignore_errors=True)

    settings = C.reference_settings(cell)
    weights = W.make(settings, seed, device)
    ref = reference(cell, settings, weights, seed, device, prog)
    del weights
    nums = judge.numbers(prog, ref)
    limits = cell.limits["limits"]
    correct, lines = judge.verdict(nums, limits)

    ctx = RunContext(cell, settings, prog)
    metrics = {}
    for m in cell.metrics(trace):
        value = C.reader(m["name"], cell.bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": prog.memory_peak_bytes}
    if device.type == "cuda":
        dev["card"] = power_limit()
    if trace and prog.trace is not None:
        dev["busy_s"] = prog.trace["busy_s"]
        dev["window_s"] = prog.trace["window_s"]
    result = {"correct": correct, "attempted": prog.attempted, "failed": prog.failed, "metrics": metrics,
              "device": dev}
    if trace and prog.trace is not None:
        result["breakdown"] = {"device_ops": prog.trace["device_ops"], "idle_gaps": prog.trace["idle_gaps"]}
    result["checks"] = {name: {"value": nums.get(name, float("nan")), "limit": float(limits[name])}
                        for name in judge.NUMBERS if name in limits}
    return result, lines
