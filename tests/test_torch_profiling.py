"""The port's own spans, block records and layer ranges
(``pixray_tpu_torch/engine/profiling.py``), on the CPU.

- A tiny pixel engine (TinyTest, blocks of 8, an LR drop and checkins
  inside the run) leaves one block record per dispatched block, with its
  engine, first step and steps, its span seconds and its loss wait; every
  span of the engine's table is timed.
- Under a CPU ``torch.profiler`` the block's spans (``pixray.block.draw``,
  ``...stage_wait``, ``...upload``, ``...launch``) lie inside
  ``pixray.block.dispatch``, and the others appear; with no profiler
  running no range is entered.
- The layer ranges, through a block's real capture code with CUDA's graph,
  capture flag and events stood in for on the CPU: off, no event is made;
  on, each step's tower, decoder and bank calls get a forward and a
  backward pair, the backward's ends in autograd's order, and each
  replay's device ms reach its block record and the timer's report once:
  when its losses reach the host, or before the graph's next replay.
- ``--profile_dir`` turns the ranges on before the run's first block and
  writes ``phases.txt`` beside ``trace.json``; the ring keeps its bound.
"""

import itertools
import os
from collections import deque

import pytest
import torch
import torch_parity  # noqa: F401  (torch's thread count in a pytest-xdist worker)

from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine import profiling as P
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.step import StepBlock, bank_rows

RUN = dict(drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[64, 36], num_cuts=4, batches=1,
           iterations=24, save_every=10, learning_rate_drops=[50], seed=3, init_noise=None,
           vector_prompts="none", precision="fp32", save_intermediates=True)

# every span of the engine that a CPU run reaches (a capture needs the card)
SPANS = ["build", "build.drawer", "build.towers", "build.prompts", "build.step", "block.dispatch",
         "block.stage_wait", "block.draw", "block.upload", "block.launch", "block.loss_wait", "step.eager",
         "checkin", "checkin.render", "checkin.png"]
IN_DISPATCH = ["block.stage_wait", "block.draw", "block.upload", "block.launch"]


def _engine(tmp_path, **extra):
    return Engine(apply_settings(dict(RUN, outdir=str(tmp_path), **extra), apply_side_effects=False), device="cpu")


def _train(engine, steps):
    for it in range(steps):
        if not engine.train(it):
            break


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A 25-step run under a CPU profiler: (engine, its spans' timer, profiler events, its records)."""
    before = P.TIMER.since()
    engine = _engine(tmp_path_factory.mktemp("profiled"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(engine, 25)
    records = [b for b in P.BLOCKS if b.engine == engine.serial]
    return engine, P.TIMER.since(before), prof.events(), records


@pytest.mark.parametrize("name", SPANS)
def test_every_span_is_timed(profiled, name):
    _engine_, timer, _events, _records = profiled
    assert timer.counts[name] >= 1 and timer.totals[name] >= 0.0
    assert P.TIMER.last[name] >= 0.0


def test_one_record_per_block(profiled):
    engine, timer, _events, records = profiled
    # checkins at 0, 10, 20 and 24, the LR drop at 11: blocks 1-8 and 12-19
    assert engine.dispatched_blocks == [(1, 8), (12, 8)]
    assert [(b.first, b.n) for b in records] == engine.dispatched_blocks
    assert timer.counts["block.dispatch"] == len(records)
    for b in records:
        assert b.draw_s > 0 and b.launch_s > 0 and b.upload_s > 0 and b.stage_wait_s >= 0
        assert b.loss_wait_s is not None and b.capture_s == 0.0 and b.device_ms is None
    assert sum(b.launch_s for b in records) == pytest.approx(timer.totals["block.launch"])
    assert timer.counts["step.eager"] == 24 - 16


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == P.SPAN_PREFIX + name]


@pytest.mark.parametrize("name", IN_DISPATCH)
def test_block_spans_nest_in_dispatch(profiled, name):
    _engine_, _timer, events, _records = profiled
    outer, inner = _ranges(events, "block.dispatch"), _ranges(events, name)
    assert len(outer) == len(inner) == 2
    for a, b in inner:
        assert any(s <= a and b <= t for s, t in outer)


@pytest.mark.parametrize("name", ["block.loss_wait", "step.eager", "checkin", "checkin.render", "checkin.png"])
def test_other_spans_reach_the_trace(profiled, name):
    _engine_, timer, events, _records = profiled
    found = _ranges(events, name)
    assert len(found) == timer.counts[name]
    outer = _ranges(events, "block.dispatch")
    assert not any(s <= a and b <= t for a, b in found for s, t in outer)


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    engine = _engine(tmp_path, iterations=12, learning_rate_drops=[100])
    _train(engine, 13)
    assert engine.dispatched_blocks == [(1, 8)]


# ------------------------------------------------------------------ layer ranges
class FakeEvent:
    """``torch.cuda.Event`` on the CPU: a record takes the next tick of a clock."""

    made = 0
    clock = itertools.count(1)

    def __init__(self, enable_timing=False, blocking=False, interprocess=False, external=False):
        FakeEvent.made += 1
        assert enable_timing and external
        self.t = None

    def record(self, stream=None):
        self.t = next(FakeEvent.clock)

    def elapsed_time(self, other):
        return float(other.t - self.t)


class FakeGraph:
    def __init__(self, keep_graph=False):
        pass

    def instantiate(self):
        pass


class FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class FakeDone:
    """A block's ``done`` event: counts the host's waits on it."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.fixture
def fake_capture(monkeypatch):
    """CUDA's graph, streams, capture flag and events stood in for: a
    capture runs the steps eagerly on the CPU, as if recorded."""
    from pixray_tpu_torch.engine import step

    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: _nothing())
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, capture_error_mode=None: _nothing())
    monkeypatch.setattr(step, "_WARMUP_STREAMS", {})
    yield monkeypatch
    P.time_layers(False)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _captured_block(tmp_path, monkeypatch, layers: bool):
    """A 2-step block of a tiny engine, its inputs staged, captured by
    ``StepBlock._capture`` with the layer ranges ``layers``."""
    engine = _engine(tmp_path, iterations=12, learning_rate_drops=[100])
    blk = StepBlock(engine.step_cfg, engine.optimizer, 2, bank_rows(engine.step_cfg, 4), "cpu")
    rows, ints = blk.staging_inputs()
    for s in range(2):
        from pixray_tpu_torch.engine.step import pack_step

        pack_step(engine.step_cfg, engine.draw_step(planes_out=blk.plane_targets(s)), 1 + s, rows[s], ints[s])
    blk.upload()
    P.time_layers(layers)
    capturing = [False]  # the warm-up step runs outside the capture
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
        m.setattr(torch.cuda, "graph", lambda graph, capture_error_mode=None: _capturing(capturing))
        blk._capture(engine.z, engine.opt_state, engine.lr_scale)
    return engine, blk, blk.ranges


class _capturing(_nothing):
    def __init__(self, flag):
        self.flag = flag

    def __enter__(self):
        self.flag[0] = True
        return self

    def __exit__(self, *exc):
        self.flag[0] = False
        return False


@pytest.mark.parametrize("layers", [False, True], ids=["off", "on"])
def test_ranges_make_events_only_when_on(tmp_path, fake_capture, layers):
    _engine_, blk, ranges = _captured_block(tmp_path, fake_capture, layers)
    if not layers:
        assert ranges is None and FakeEvent.made == 0
        return
    names = [name for name, _b, _e in ranges.pairs]
    # per step: the decoder (the drawer's synth), the bank, the tower; forward and backward each
    assert sorted(names) == sorted(["decoder", "bank", "tower.TinyTest"] * 2 * 2)
    assert FakeEvent.made == len(names) * 2
    assert all(begin.t < end.t for _n, begin, end in ranges.pairs)


def test_backward_ranges_follow_autograd_order(tmp_path, fake_capture):
    _engine_, _blk, ranges = _captured_block(tmp_path, fake_capture, True)
    step = ranges.pairs[:6]  # the first step's: each call's forward pair, then its backward pair
    assert [name for name, _b, _e in step] == ["decoder", "decoder", "bank", "bank", "tower.TinyTest", "tower.TinyTest"]
    fwd = {name: (b.t, e.t) for name, b, e in step[0::2]}
    bwd = {name: (b.t, e.t) for name, b, e in step[1::2]}
    assert fwd["decoder"][1] < fwd["bank"][0] < fwd["bank"][1] < fwd["tower.TinyTest"][0]
    assert fwd["tower.TinyTest"][1] < bwd["tower.TinyTest"][0]
    # the backward runs tower, bank, decoder, each inside its own pair
    assert bwd["tower.TinyTest"][1] < bwd["bank"][0] < bwd["bank"][1] < bwd["decoder"][0]


def test_each_replay_is_read_once(tmp_path, fake_capture, monkeypatch):
    from pixray_tpu_torch.engine.step import BlockResult

    timer = P.PhaseTimer()
    monkeypatch.setattr(P, "TIMER", timer)
    _engine_, _blk, ranges = _captured_block(tmp_path, fake_capture, True)
    want = {}
    for name, begin, end in ranges.pairs:
        want[name] = want.get(name, 0.0) + (end.t - begin.t)
    records = [P.BlockRecord(7, 1 + 2 * k, 2) for k in range(3)]
    dones = [FakeDone() for _ in records]

    def result(k):
        return BlockResult(torch.zeros(2), torch.zeros(2, 1), records[k], dones[k], ranges)

    # block 0's losses reach the host before the next replay: read there
    ranges.replayed(records[0], dones[0])
    result(0).host()
    assert records[0].device_ms == want and records[0].loss_wait_s is not None
    ranges.read()  # the next replay finds nothing left to read
    # block 1's losses come after block 2's replay: read before that replay,
    # which waits for block 1; block 1's host() then reads nothing again
    ranges.replayed(records[1], dones[1])
    ranges.read()
    assert records[1].device_ms == want and dones[1].waits == 1
    ranges.replayed(records[2], dones[2])
    result(1).host()
    assert records[2].device_ms is None and timer.device_steps["bank"] == 4
    result(2).host()
    assert records[2].device_ms == want and dones[2].waits == 2  # the loss wait, then the read's
    assert timer.device_steps == {name: 6 for name in want}
    assert f"tower.TinyTest: {want['tower.TinyTest'] / 2:.3f} ms per step on the device / 6 steps" in timer.report()


def test_profile_dir_turns_ranges_on_and_writes_phases(tmp_path, monkeypatch):
    seen = []
    run = StepBlock.run

    def watching_run(self, *args, **kwargs):
        seen.append(P.layers_on())
        return run(self, *args, **kwargs)

    monkeypatch.setattr(StepBlock, "run", watching_run)
    assert not P.layers_on()
    prof = tmp_path / "prof"
    engine = _engine(tmp_path, iterations=12, learning_rate_drops=[100], profile_dir=str(prof),
                     save_intermediates=False)
    engine.run()
    assert seen == [True] and not P.layers_on()  # on before the first block, restored after the run
    assert sorted(os.listdir(prof)) == sorted([P.PHASES_FILE, P.TRACE_FILE])
    report = (prof / P.PHASES_FILE).read_text()
    for name in ("build", "block.dispatch", "block.draw", "checkin"):
        assert f"\n{name}: " in "\n" + report


def test_timer_since_takes_the_difference():
    timer = P.PhaseTimer()
    timer.add("a", 1.0)
    timer.add_device({"bank": 4.0}, 2)
    before = timer.since()
    timer.add("a", 0.5)
    timer.add("b", 0.25)
    timer.add_device({"bank": 6.0}, 2)
    after = timer.since(before)
    assert dict(after.totals) == {"a": 0.5, "b": 0.25} and dict(after.counts) == {"a": 1, "b": 1}
    assert dict(after.device_ms) == {"bank": 6.0} and dict(after.device_steps) == {"bank": 2}
    assert timer.last == {"a": 0.5, "b": 0.25}


def test_ring_keeps_its_bound():
    # at least 4x the blocks of a 51 s window of the fastest cell (~120 steps/s, blocks of 8)
    assert P.BLOCKS.maxlen == P.BLOCK_RING >= 4 * 51 * 120 / 8
    ring = deque(P.BLOCKS, maxlen=P.BLOCKS.maxlen)
    for i in range(P.BLOCK_RING + 3):
        ring.append(P.BlockRecord(0, 1 + 8 * i, 8))
    assert len(ring) == P.BLOCK_RING and ring[0].first == 1 + 8 * 3
