"""Profiling (port of ``pixray_tpu/engine/profiling.py``): a device trace
of a run, host spans, block records and device layer ranges.

``--profile_dir`` traces the run with ``torch.profiler`` (host and, for a
run on the card, device activity: every kernel, graph replays included)
and writes it into the directory as a Chrome trace, ``trace.json``,
where the JAX package writes ``jax.profiler``'s; beside it
``phases.txt``, the :class:`PhaseTimer` report of the engine's build and
run, with each layer range's device ms per step.  The run turns the layer
ranges on before its first capture.

Host spans.  :class:`span` times one phase on the host clock into the
process-wide ``TIMER`` (totals, counts, each phase's last seconds) and,
while ``torch.profiler`` records, is also a record-function range of the
same name prefixed ``pixray.``, so a device trace shows on the device's
clock which span the host was in.  The range is a plain function range
(``_RecordFunctionFast``): ``torch.profiler.record_function`` opens a
user-scope range, which the profiler also mirrors onto the device's
timeline as an annotation over the kernels launched inside it, and a
reader of the trace's device events would count that as device work.
Spans are per block or per phase, never per kernel:

    build (build.drawer, build.towers, build.prompts, build.step)  Engine.__init__
    block.dispatch   Engine._dispatch_block, the whole call
    block.stage_wait the sync on the staging buffer about to be refilled
    block.draw       the host's draws and packing of the block's steps
    block.upload     the staging copy and its event
    block.capture    a block's graph captured (warm-up step, capture, instantiate)
    block.launch     the replay, the pinned loss buffers, their copies, the done event
                     (on the CPU: the block's eager steps; with the layer ranges on,
                     first the wait for the graph's last replay, whose events it reads)
    block.loss_wait  the host blocked on a block's losses
    step.eager       one eager step's dispatch
    checkin (checkin.render, checkin.png)  Engine.checkin

Block records.  ``BLOCKS`` keeps the last ``BLOCK_RING`` block dispatches
of the process, a :class:`BlockRecord` each (its engine, first step,
steps and span seconds; the loss wait once the losses reached the host;
the layer ranges' device ms once read).  Readers pick records by engine
and first step.  A graph captured again shows as a record with
``capture_s`` and as a ``block.capture`` count in ``TIMER``; on the card
``block.launch`` counts the replays.

Device layer ranges, off by default (:func:`time_layers`).  While on, a
block's capture puts timing events (``external``: event record nodes)
around each call that :func:`ranged` wraps: a tower's ``image_fn``
(``tower.<name>``), the drawer's ``synth`` (``decoder``) and a cutout bank
(``bank``), forward and backward (an identity autograd function on the
call's input and output records the backward's two ends).  Every call of
every step has its own events, and every replay records them again, so a
replay's events are read once its ``done`` has passed and before the
graph's next replay: when its losses reach the host, or else just before
that replay, which then waits for it.  While off, no event is made and the
graph is what it was without ranges.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import torch

TRACE_FILE = "trace.json"
PHASES_FILE = "phases.txt"
SPAN_PREFIX = "pixray."
BLOCK_RING = 16384  # block records kept: ~20x the blocks of a 51 s window at 120 steps/s


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}  # each phase's last seconds
        self.device_ms = defaultdict(float)  # each layer range's device ms, summed
        self.device_steps = defaultdict(int)  # and the steps they cover
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            self.last[name] = seconds

    def add_device(self, ms: dict, steps: int):
        """Add one block's device ms by layer range, over its ``steps`` steps."""
        with self._lock:
            for name, value in ms.items():
                self.device_ms[name] += value
                self.device_steps[name] += steps

    def since(self, before: PhaseTimer | None = None) -> PhaseTimer:
        """What was added after ``before`` (a :meth:`since` copy taken
        earlier); a copy of everything without it."""
        out = PhaseTimer()
        with self._lock:
            for name, total in self.totals.items():
                n = self.counts[name] - (before.counts.get(name, 0) if before else 0)
                if n:
                    out.totals[name] = total - (before.totals.get(name, 0.0) if before else 0.0)
                    out.counts[name] = n
            for name, ms in self.device_ms.items():
                steps = self.device_steps[name] - (before.device_steps.get(name, 0) if before else 0)
                if steps:
                    out.device_ms[name] = ms - (before.device_ms.get(name, 0.0) if before else 0.0)
                    out.device_steps[name] = steps
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total / {n} calls = {total / n * 1000:.2f} ms")
        for name in sorted(self.device_ms, key=self.device_ms.get, reverse=True):
            steps = self.device_steps[name]
            lines.append(f"{name}: {self.device_ms[name] / steps:.3f} ms per step on the device / {steps} steps")
        return "\n".join(lines)


TIMER = PhaseTimer()  # the process's spans
ENGINES = itertools.count()  # each engine's serial, which its block records carry


@dataclass(slots=True)
class BlockRecord:
    """One block dispatch: its engine's serial, first step, steps, and the
    seconds of its spans (``capture_s`` 0 where it captured nothing);
    ``loss_wait_s`` once its losses reached the host, ``device_ms`` (layer
    range → device ms over the block) once its ranges were read."""

    engine: int | None
    first: int | None
    n: int
    stage_wait_s: float = 0.0
    draw_s: float = 0.0
    upload_s: float = 0.0
    launch_s: float = 0.0
    capture_s: float = 0.0
    loss_wait_s: float | None = None
    device_ms: dict | None = None


BLOCKS: deque = deque(maxlen=BLOCK_RING)


class span:
    """``with span(name) as s:`` times the block into ``TIMER`` (``s.seconds``
    after it), and while the profiler records opens the host range
    ``pixray.<name>``."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name, self.seconds, self._range = name, 0.0, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        TIMER.add(self.name, self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


# ------------------------------------------------------------------ layer ranges
_layers_on = False
_recording = None  # the LayerRanges of the capture in progress


def time_layers(on: bool) -> bool:
    """Switch the device layer ranges on or off for the blocks captured
    from now on; returns the previous setting."""
    global _layers_on
    prev, _layers_on = _layers_on, bool(on)
    return prev


def layers_on() -> bool:
    return _layers_on


class _Mark(torch.autograd.Function):
    """Identity; its backward records ``event`` (a layer's backward end on
    its input, its backward begin on its output)."""

    @staticmethod
    def forward(ctx, x, ranges, event):
        ctx.ranges, ctx.event = ranges, event
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.ranges.record(ctx.event)
        return g, None, None


class LayerRanges:
    """The timing events of one graph's capture: (range, begin, end) pairs,
    kept where the capture recorded both; ``last``: the record and ``done``
    event of the graph's last replay while its events are unread."""

    def __init__(self):
        self.pairs = []
        self.recorded = set()  # ids of the events the capture recorded
        self.last = None

    def event(self, record: bool = True):
        ev = torch.cuda.Event(enable_timing=True, external=True)
        if record:
            self.record(ev)
        return ev

    def record(self, ev):
        ev.record()
        self.recorded.add(id(ev))

    def call(self, name: str, fn, args, kwargs, at: int):
        args = list(args)
        x = args[at]
        grad = torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad
        if grad:
            bwd_end = self.event(record=False)
            args[at] = _Mark.apply(x, self, bwd_end)
        begin = self.event()
        out = fn(*args, **kwargs)
        self.pairs.append((name, begin, self.event()))
        if grad and isinstance(out, torch.Tensor) and out.requires_grad:
            bwd_begin = self.event(record=False)
            out = _Mark.apply(out, self, bwd_begin)
            self.pairs.append((name, bwd_begin, bwd_end))
        return out

    def finish(self):
        """Drop the pairs whose backward the capture never ran."""
        self.pairs = [p for p in self.pairs if id(p[1]) in self.recorded and id(p[2]) in self.recorded]
        self.recorded = set()
        return self

    def replayed(self, record: BlockRecord, done):
        """The graph was replayed for ``record``; ``done`` follows the replay."""
        self.last = (record, done)

    def read(self, record: BlockRecord | None = None):
        """The last replay's device ms by layer range into its record and
        ``TIMER``, once, after waiting for its ``done``.  With ``record``
        only if the last replay is that record's (else it was read before
        a later replay)."""
        if self.last is None or (record is not None and self.last[0] is not record):
            return
        (last, done), self.last = self.last, None
        done.synchronize()
        ms = {}
        for name, begin, end in self.pairs:
            ms[name] = ms.get(name, 0.0) + begin.elapsed_time(end)
        last.device_ms = ms
        TIMER.add_device(ms, last.n)


@contextlib.contextmanager
def recording(ranges: LayerRanges | None):
    """The calls that :func:`ranged` wraps record into ``ranges`` while a capture is on."""
    global _recording
    prev, _recording = _recording, ranges
    try:
        yield ranges
    finally:
        _recording = prev


def ranged(name: str, fn, *args, at: int = 0, **kwargs):
    """``fn(*args, **kwargs)``, inside the device range ``name`` while a
    capture with ranges is recording on this thread's stream; ``args[at]``
    is the tensor the call works on (its gradient ends the backward)."""
    ranges = _recording
    if ranges is None or not torch.cuda.is_current_stream_capturing():
        return fn(*args, **kwargs)
    return ranges.call(name, fn, args, kwargs, at)


@contextlib.contextmanager
def device_trace(profile_dir: str | None, device, note: str = "", since: PhaseTimer | None = None):
    """A ``torch.profiler`` trace of the block, written to
    ``profile_dir/trace.json`` when it ends (an interrupt too), with the
    spans' report since ``since`` (default: the block's start) in
    ``profile_dir/phases.txt``; no-op when ``profile_dir`` is None.
    ``device``: the run's device (CUDA activity is traced for a CUDA device)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    since = TIMER.since() if since is None else since
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
        with open(os.path.join(profile_dir, PHASES_FILE), "w") as f:
            f.write(TIMER.since(since).report() + "\n")
        print(f"wrote torch profiler trace to {path} {note}")
