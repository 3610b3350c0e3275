"""The program's side of a run: set-up, the measured window, and what the
judge and the readers need from it.

Set-up builds one engine from the cell's settings and the weights made
from the seed, and walks it through the cell's warm-up steps with the
window's own call (``Engine.train``) and the loss read the window makes:
step 0 (eager, with its checkin), the first block (its graph captured and
replayed) and as many more steps as the cell's traffic names, so that every
shape and path the window runs has run once.  Those first steps are what
the reference follows: each step's loss, the first gradient (from Adam's
first moment after step 0) and the latent after the first block, the
first state that the blocked path leaves readable after step 0.  Where the
reference starts from the program's latent (``"start": "program"``), the
build also keeps the program's init image and its drawer's encoding of it
before quantization (``starts/<drawer>.json`` names the function whose
tensor argument that is), for the reference to check the init by itself.

The window then calls ``Engine.train`` step after step, reading each
step's loss on the host, for ``seconds`` of host clock; it counts the steps
whose work was dispatched inside it (every one finished by the closing
synchronize) and the steps whose loss was not finite.
"""

from __future__ import annotations

import math
import tempfile
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import cell as C
from portbench.harness import spans as S
from portbench.harness import trace as T
from portbench.harness import weights as W


@dataclass
class ProgramRun:
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    losses: list = field(default_factory=list)  # the warm-up steps' losses, step 0 first
    grad0: torch.Tensor | None = None
    z0: torch.Tensor | None = None
    z_block: torch.Tensor | None = None  # the latent after the first block
    z1: torch.Tensor | None = None  # the latent after step 0
    init_image: torch.Tensor | None = None  # the init image the drawer encoded, (H, W, 3) in [-1, 1]
    init_pre: torch.Tensor | None = None  # its encoding before quantization, as the drawer's model made it
    image1: torch.Tensor | None = None  # step 0's checkin render of z1, (H, W, 3) float32
    followed_steps: int = 0  # steps up to the end of the first block
    dispatch_s: float = 0.0  # host seconds inside the block dispatches of the window
    dispatch_steps: int = 0
    trace: dict | None = None
    engine: object = None  # the engine, until ``release``
    jittered: list = field(default_factory=list)  # per traced step, per tower: cuts jittered


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite_loss(engine) -> float:
    return float(engine.last_loss_values.float().sum())


def _keep_init(cell: C.Cell, kept: dict) -> list:
    """Wrap the engine's init image (``Engine._init_tensor``) and the
    drawer's encoding function (``starts/<drawer>.json``) to keep the
    image and the encoding's first tensor argument; returns the undo list."""
    from pixray_tpu_torch.engine.core import Engine

    spec = C.start_spec(cell)
    init_tensor = Engine._init_tensor

    def kept_init_tensor(self, args):
        image = init_tensor(self, args)
        if image is not None and "image" not in kept:
            kept["image"] = image.detach().clone()
        return image

    owner, name = T.resolve(spec["target"])
    encoding, arg = getattr(owner, name), int(spec["tensor_arg"])

    def kept_encoding(*args, **kwargs):
        if "pre" not in kept:
            kept["pre"] = args[arg].detach().float().clone()
        return encoding(*args, **kwargs)

    Engine._init_tensor = kept_init_tensor
    setattr(owner, name, kept_encoding)
    return [(Engine, "_init_tensor", init_tensor), (owner, name, encoding)]


def build(cell: C.Cell, seed: int, device, outdir: str, layer_log=None, kept: dict | None = None):
    """The engine of a cell on ``device`` with the seed's weights; with
    ``layer_log`` the markers of the layers its readers read are installed
    first; with ``kept`` (a dict) the init image and its encoding are kept
    into it."""
    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    settings = apply_settings(C.program_settings(cell, seed, outdir), apply_side_effects=False)
    state_dicts = W.make(C.reference_settings(cell), seed, device)
    undo = []
    if layer_log is not None:
        marked = C.layers(cell.marked_layers(), cell.bench_dir)
        undo = T.install(marked, layer_log) + T.install_block_replays(layer_log)
    init_undo = _keep_init(cell, kept) if kept is not None else []
    try:
        engine = Engine(settings, device=str(device), state_dicts=state_dicts)
    finally:
        T.uninstall(init_undo)
    del state_dicts
    return engine, undo


def run(cell: C.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> ProgramRun:
    device = torch.device(device)
    out = ProgramRun()
    outdir = tempfile.mkdtemp(prefix="portbench-")
    log = T.Log() if trace else None
    kept = {} if C.start(cell) == "program" else None
    engine, undo = build(cell, seed, device, outdir, log, kept)
    if kept is not None:
        out.init_image, out.init_pre = kept.get("image"), kept.get("pre")
    try:
        _run(engine, cell, seconds, trace, device, t_start, out, log)
    finally:
        T.uninstall(undo)
    out.engine = engine
    return out


def _run(engine, cell, seconds, trace, device, t_start, out, log):
    span = (lambda name: torch.profiler.record_function(name)) if trace else None
    out.z0 = engine.z.detach().clone()
    dispatch = engine._dispatch_block
    timing = {"on": False}

    def dispatch_block(cur_it, n):
        t0 = time.perf_counter()
        if span is not None:
            with span("pb:dispatch"):
                res = dispatch(cur_it, n)
        else:
            res = dispatch(cur_it, n)
        if timing["on"]:
            out.dispatch_s += time.perf_counter() - t0
            out.dispatch_steps += n
        if out.z_block is None:
            out.z_block = engine.z.detach().clone()
            out.followed_steps = cur_it + n
        return res

    engine._dispatch_block = dispatch_block
    if span is not None:
        checkin = engine.checkin

        def traced_checkin(it, values):
            with span("pb:checkin"):
                return checkin(it, values)

        engine.checkin = traced_checkin
        draw = engine.draw_step

        def counted_draw(planes_out=None):
            draws = draw(planes_out=planes_out)
            out.jittered.append([int(pd["jitter"][2].sum()) for pd in draws[0]["perceptors"]])
            return draws

        engine.draw_step = counted_draw

    def read_loss():
        if span is None:
            return _finite_loss(engine)
        with span("pb:loss_read"):
            return _finite_loss(engine)

    synth_array = engine.synth_array

    def kept_synth(iteration=None):
        arr = synth_array(iteration)
        if out.image1 is None:
            out.image1 = torch.from_numpy(arr.copy())
        return arr

    engine.synth_array = kept_synth
    warmup = int(cell.traffic["warmup_steps"])
    for it in range(warmup):
        engine.train(it)
        out.losses.append(read_loss())
        if it == 0:
            opt = engine.optimizer
            out.grad0 = engine.opt_state.mu.detach().clone() / (1 - opt.b1)
            out.z1 = engine.z.detach().clone()
    engine.synth_array = synth_array
    if out.z_block is None or out.image1 is None:
        raise RuntimeError(f"the {warmup} warm-up steps dispatched no block or made no checkin")
    out.losses = out.losses[:out.followed_steps]
    _sync(device)
    out.setup_s = time.perf_counter() - t_start

    losses = []
    timing["on"] = True
    first = engine.steps_dispatched
    it = warmup
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        engine.train(it)
        losses.append(read_loss())
        it += 1
    _sync(device)
    out.window_s = time.perf_counter() - t0
    timing["on"] = False
    out.attempted = engine.steps_dispatched - first
    out.failed = sum(1 for v in losses if not math.isfinite(v))
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace:
        out.trace = _traced_walk(engine, cell, it, log, out, read_loss)


def _traced_walk(engine, cell, it, log, out, read_loss):
    """The device numbers of whole cycles of the cell's traffic, traced."""
    from pixray_tpu_torch.ops import cuda_warp

    steps = int(cell.limits["trace_steps"])
    state = {"it": it}
    while (state["it"] - 1) % steps:  # start where a cycle starts: after a checkin, at a block's first step
        engine.train(state["it"])
        read_loss()
        state["it"] += 1
    names = set(cuda_warp.KERNEL_NAMES.values())
    P = S.profiling()

    def walk():
        labels0, jitter0 = len(log.labels), len(out.jittered)
        launches0, dispatched0 = dict(cuda_warp.LAUNCHES), engine.steps_dispatched
        timer0 = None if P is None else P.TIMER.since()
        for _ in range(steps):
            engine.train(state["it"])
            read_loss()
            state["it"] += 1
        launched = {k: v - launches0[k] for k, v in cuda_warp.LAUNCHES.items()}
        spans = {} if P is None else P.TIMER.since(timer0)
        return {"labels": log.labels[labels0:], "jittered": out.jittered[jitter0:],
                "launches": sum(v for k, v in launched.items() if k in cuda_warp.KERNEL_NAMES),
                "steps": engine.steps_dispatched - dispatched0,
                "spans": {} if P is None else {k: {"s": spans.totals[k], "n": spans.counts[k]} for k in spans.counts}}

    events, book = T.profiled_walk(walk, complete=lambda ev, bk: T.check_complete(ev, bk, names))
    summary = T.analyse(events, book["labels"], book["steps"])
    summary["jittered"] = book["jittered"]
    summary["spans"] = book["spans"]  # the program's host spans over the walk: seconds and count by name
    return summary


def release(run_: ProgramRun):
    """Free the program's state before the reference runs."""
    run_.engine = None
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
