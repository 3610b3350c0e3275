"""The traced run's instruments: layer markers, host spans, the profiler window.

Markers.  Each layer of ``layers/*.json`` names a function of the program
(``module:attr``) and which positional argument is the tensor it works on.
Its wrapper launches a one-cycle ``torch.cuda._sleep`` kernel before and
after the call, and (through an identity autograd function on the input
and the output) before and after its backward.  Every marker kernel has
the same name, so each launch appends its label (layer, begin or end) to a
log in launch order: inside a CUDA-graph capture to the block's own list,
which every replay of that block appends again.  The k-th marker kernel on
the device's timeline then carries the k-th label of the log.  Markers are
installed before the engine is built: the step binds the functions it calls
when it is built.

Host spans.  ``record_function`` ranges around the engine's block dispatch
(``pb:dispatch``), its checkin (``pb:checkin``), the harness's loss read
(``pb:loss_read``) and each traced walk (``pb:walk``) land in the same
profiler timeline as the device's kernels.

The window.  A walk of whole checkin cycles or blocks is traced under
``torch.profiler`` with host pauses around it, after a discarded warm-up
walk (the profiler starts tracing the card late, and drops events near its
window's edges).  A window is complete when it holds one marker kernel per
label logged and one bank kernel per launch counted; one that is not is
taken again.
"""

from __future__ import annotations

import importlib
import time

import torch

MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
PAUSE_S = 0.03


class Log:
    """The marker labels in launch order, and those of the capture in progress."""

    def __init__(self):
        self.labels: list[tuple[str, str]] = []
        self.capturing: list[tuple[str, str]] = []

    def emit(self, layer: str, what: str):
        torch.cuda._sleep(1)
        if torch.cuda.is_current_stream_capturing():
            self.capturing.append((layer, what))
        else:
            self.labels.append((layer, what))


def resolve(target: str):
    """(owner, attribute name) of a ``module:attr.attr`` target."""
    module_name, attr = target.split(":")
    owner = importlib.import_module(module_name)
    parts = attr.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def install(layers: dict, log: Log) -> list:
    """Wrap every layer's function with markers; returns the undo list."""
    undo = []
    for layer, spec in layers.items():
        owner, name = resolve(spec["target"])
        orig = getattr(owner, name)
        arg = int(spec["tensor_arg"])

        class Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, what):
                ctx.what = what
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g, _layer=layer):
                log.emit(_layer, ctx.what)
                return g, None

        def marked(*args, _orig=orig, _layer=layer, _arg=arg, _mark=Mark, **kwargs):
            args = list(args)
            log.emit(_layer, "fwd_begin")
            if torch.is_grad_enabled() and args[_arg].requires_grad:
                args[_arg] = _mark.apply(args[_arg], "bwd_end")
            out = _orig(*args, **kwargs)
            log.emit(_layer, "fwd_end")
            if torch.is_grad_enabled() and out.requires_grad:
                out = _mark.apply(out, "bwd_begin")
            return out

        setattr(owner, name, marked)
        undo.append((owner, name, orig))
    return undo


def install_block_replays(log: Log) -> list:
    """Make every ``StepBlock`` replay append the labels its capture recorded."""
    from pixray_tpu_torch.engine.step import StepBlock

    orig = StepBlock.run

    def run(self, *args, **kwargs):
        if self.device.type == "cuda" and self.graph is None:
            log.capturing = []
        out = orig(self, *args, **kwargs)
        if self.device.type == "cuda":
            if not hasattr(self, "_portbench_labels"):
                self._portbench_labels = list(log.capturing)
            log.labels.extend(self._portbench_labels)
        return out

    StepBlock.run = run
    return [(StepBlock, "run", orig)]


def uninstall(undo: list):
    for owner, name, orig in reversed(undo):
        setattr(owner, name, orig)


def profiled_walk(walk, complete, tries: int = 3):
    """Trace ``walk()`` (after one discarded warm-up walk) and return its
    events and the walk's own bookkeeping, from the first of ``tries``
    windows that ``complete(events, book)`` accepts; ``walk`` returns its
    bookkeeping (labels and counters it saw)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        books, traces = [], []
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=schedule,
                                    on_trace_ready=lambda p: traces.append(list(p.events()))) as prof:
            for _ in range(2):
                time.sleep(PAUSE_S)
                with torch.profiler.record_function("pb:walk"):
                    books.append(walk())
                    torch.cuda.synchronize()
                time.sleep(PAUSE_S)
                prof.step()
        if traces:
            events, book = traces[-1], books[-1]
            ok, why = complete(events, book)
            if ok:
                return events, book
            seen.append(why)
    raise RuntimeError(f"no complete profiler window in {tries}: {seen}")


def device_events(events):
    """The device's kernels and copies in start order: without the
    profiler's step annotations and the host spans' mirrors on the device."""
    return sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("ProfilerStep", "pb:"))), key=lambda e: e.time_range.start)


def host_spans(events, prefix: str = "pb:"):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(prefix)]


def analyse(events, labels: list, steps: int) -> dict:
    """Device numbers of a traced walk of ``steps`` steps: per layer the
    device time of the kernels between its markers, busy and window
    seconds, kernels by name, and the idle gaps labelled by host span."""
    dev = device_events(events)
    spans = host_spans(events)
    walk = [s for s in spans if s[0] == "pb:walk"]
    if not walk:
        raise RuntimeError("the traced window holds no pb:walk span")
    w0, w1 = walk[-1][1], walk[-1][2]
    dev = [e for e in dev if e.time_range.end > w0 and e.time_range.start < w1]
    markers = [e for e in dev if MARKER_KERNEL in e.name]
    work = [e for e in dev if MARKER_KERNEL not in e.name]
    layer_us, open_layers, k = {}, set(), 0
    for e in dev:
        if MARKER_KERNEL in e.name:
            if k >= len(labels):  # more marker kernels than labels: the window is not complete
                break
            layer, what = labels[k]
            k += 1
            if what.endswith("begin"):
                open_layers.add(layer)
            else:
                open_layers.discard(layer)
            continue
        for layer in open_layers:
            layer_us[layer] = layer_us.get(layer, 0.0) + e.time_range.elapsed_us()
    by_name = {}
    busy, cur, gaps, last_end = 0.0, None, [], w0
    for e in work:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        if s > last_end:
            gaps.append((last_end, s))
        last_end = max(last_end, t)
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    if w1 > last_end:
        gaps.append((last_end, w1))

    def label(a, b):
        mid = 0.5 * (a + b)
        inside = [n for n, s, t in spans if n != "pb:walk" and s <= mid <= t]
        return inside[-1][3:] if inside else "other"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "steps": steps,
        "markers": len(markers),
        "layer_ms": {k_: us / 1e3 / steps for k_, us in layer_us.items()},
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(([n, us / 1e6] for n, us in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in gaps[:10]],
        "kernel_counts": _counts(work),
    }


def check_complete(events, book: dict, bank_kernels) -> tuple[bool, dict]:
    """A traced walk is complete when its window holds one marker kernel
    per label the walk logged and one bank kernel (a name of
    ``bank_kernels`` in the kernel's name) per bank launch it counted."""
    summary = analyse(events, book["labels"], max(book["steps"], 1))
    bank = sum(n for name, n in summary["kernel_counts"].items() if any(k in name for k in bank_kernels))
    ok = summary["markers"] == len(book["labels"]) and bank == book["launches"]
    return ok, {"markers": summary["markers"], "labels": len(book["labels"]), "bank": bank,
                "launches": book["launches"]}


def _counts(work):
    out = {}
    for e in work:
        out[e.name] = out.get(e.name, 0) + 1
    return out


def idle_pct(summary: dict | None, steps_per_s: float):
    """The device's idle share at ``steps_per_s``, in percent, from a traced
    walk's busy seconds per step; None without a walk."""
    if summary is None or not summary["steps"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["steps"] * steps_per_s)
