"""Profiling (port of ``pixray_tpu/engine/profiling.py``): a device trace
of a run and per-phase host timers.

``--profile_dir`` traces the run with ``torch.profiler`` (host and, for a
run on the card, device activity: every kernel, graph replays included)
and writes it into the directory as a Chrome trace, ``trace.json``,
where the JAX package writes ``jax.profiler``'s.  ``PhaseTimer`` sums
host-side phase times.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

TRACE_FILE = "trace.json"


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total / {n} calls = {total / n * 1000:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(profile_dir: str | None, device, note: str = ""):
    """A ``torch.profiler`` trace of the block, written to
    ``profile_dir/trace.json`` when it ends (an interrupt too); no-op when
    ``profile_dir`` is None.  ``device``: the run's device (CUDA activity
    is traced for a CUDA device)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        print(f"wrote torch profiler trace to {path} {note}")
