"""The readers of the program's own spans and block records
(``harness/spans.py`` and its readers in ``metrics/``).

Each reader on a synthetic ring of block records (an earlier engine's
records and the set-up's and traced walk's blocks left out) and timer;
every one gives nothing for a program without the records; the window's
blocks that the readers select sum to the steps that ``drive`` counts in
its dispatch wrapper, for the tiny cells on the CPU; no reader, untraced
or traced, switches the program's layer ranges on.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace

import pytest
import torch
from conftest_tiny import tiny_checkout

from portbench.harness import cell as C
from portbench.harness import drive, spans
from portbench.harness.measure import RunContext
from pixray_tpu_torch.engine import profiling as P

SEED = 2200000321
NEW = ["draw_ms.steady", "launch_ms.steady", "host_wait_ms.steady", "build_s", "capture_s"]


def _record(engine, first, capture_s=0.0, loss_wait_s=0.002):
    return P.BlockRecord(engine, first, 8, stage_wait_s=0.001, draw_s=0.004 * (1 + (first == 25)),
                         upload_s=0.0001, launch_s=0.016, capture_s=capture_s, loss_wait_s=loss_wait_s)


@pytest.fixture
def ring(monkeypatch):
    """Engine 3's run (warm-up 17 steps, 24 attempted: the window's blocks
    start at 17, 25 and 33) after engine 2's blocks; the window's last
    block's losses never reached the host."""
    blocks = deque([_record(2, 1, capture_s=9.0), _record(2, 17)], maxlen=16)
    blocks += [_record(3, 1, capture_s=5.5), _record(3, 9), _record(3, 17), _record(3, 25),
               _record(3, 33, loss_wait_s=None), _record(3, 41)]
    timer = P.PhaseTimer()
    timer.add("build", 12.0)
    timer.add("build", 4.25)  # this run's engine's, the last
    monkeypatch.setattr(P, "BLOCKS", blocks)
    monkeypatch.setattr(P, "TIMER", timer)
    yield SimpleNamespace(cell=SimpleNamespace(traffic={"warmup_steps": 17}), prog=SimpleNamespace(attempted=24))


@pytest.mark.parametrize("name, want", [
    ("draw_ms.steady", 1e3 * (0.004 + 0.008 + 0.004) / 24),
    ("launch_ms.steady", 1e3 * 0.016 / 8),
    ("host_wait_ms.steady", 1e3 * 0.003 / 8),  # the block at 33 has no loss wait: left out
    ("build_s", 4.25),
    ("capture_s", 5.5),
])
def test_reader_on_a_synthetic_ring(ring, name, want):
    assert C.reader(name).read(ring) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_records_gives_nothing(ring, monkeypatch, name):
    monkeypatch.delattr(P, "BLOCKS")  # a program before the records
    reader = C.reader(name)  # loading it raises nothing there either
    assert reader.read(ring) is None


@pytest.mark.parametrize("name", ["draw_ms.steady", "launch_ms.steady", "host_wait_ms.steady", "capture_s"])
def test_reader_with_an_empty_window_gives_nothing(ring, monkeypatch, name):
    monkeypatch.setattr(P, "BLOCKS", deque([_record(3, 1)]))
    ring.prog.attempted = 0
    want = 0.0 if name == "capture_s" else None
    assert C.reader(name).read(ring) == want


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tiny.pixel", "tiny.vqgan"])
def test_window_blocks_match_the_dispatch_wrapper(checkout, few_threads, name):
    cell = C.load(name, *checkout)
    prog = drive.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    ctx = RunContext(cell, C.reference_settings(cell), prog)
    drive.release(prog)
    blocks = spans.window_blocks(ctx)
    assert prog.dispatch_steps == prog.attempted > 0
    assert sum(b.n for b in blocks) == prog.dispatch_steps
    assert all(b.loss_wait_s is not None for b in blocks[:-1])
    for metric in ("draw_ms.steady", "launch_ms.steady", "host_wait_ms.steady", "build_s"):
        assert C.reader(metric, cell.bench_dir).read(ctx) > 0
    assert C.reader("capture_s", cell.bench_dir).read(ctx) == 0.0  # the CPU captures no graph


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", ["tiny.pixel", "tiny.vqgan"])
def test_readers_leave_the_ranges_off(checkout, name, traced):
    cell = C.load(name, *checkout)
    assert not P.layers_on()
    for m in cell.metrics(traced):  # what a run loads, as measure() does
        C.reader(m["name"], cell.bench_dir)
    if traced:
        assert set(NEW) <= {m["name"] for m in cell.metrics(True)}
        cell.marked_layers()  # a traced run loads its per-layer readers before the engine's build
    assert not P.layers_on()
