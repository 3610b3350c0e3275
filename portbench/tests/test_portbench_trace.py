"""The trace's reading of a profiler event list: layer times between
markers, busy and window seconds, idle gaps by host span, and the
completeness check refusing a window that dropped an event."""

from __future__ import annotations

from dataclasses import dataclass

import pytest
import torch

from portbench.harness import trace as T

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclass
class Range:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


@dataclass
class Ev:
    name: str
    device_type: object
    time_range: Range


def ev(name, a, b, dev=CUDA):
    return Ev(name, dev, Range(a, b))


def window(drop_k1=False):
    """One step in a 1000 us walk: bank forward (K1), tower forward, tower
    backward, bank backward (K2), with a dispatch span over the first gap."""
    events = [ev("pb:walk", 0, 1000, CPU), ev("pb:dispatch", 0, 100, CPU), ev("pb:loss_read", 900, 1000, CPU),
              ev("pb:walk", 0, 1000),  # the host span's mirror on the device: not a kernel
              ev("spin_kernel", 100, 101), ev("bank_fwd_kernel", 101, 151), ev("spin_kernel", 151, 152),
              ev("spin_kernel", 152, 153), ev("gemm", 153, 353), ev("spin_kernel", 353, 354),
              ev("spin_kernel", 400, 401), ev("gemm_dx", 401, 701), ev("spin_kernel", 701, 702),
              ev("spin_kernel", 702, 703), ev("bank_bwd_kernel", 703, 803), ev("spin_kernel", 803, 804),
              ev("adam", 804, 850)]
    if drop_k1:
        events = [e for e in events if e.name != "bank_fwd_kernel"]
    labels = [("bank", "fwd_begin"), ("bank", "fwd_end"), ("towers", "fwd_begin"), ("towers", "fwd_end"),
              ("towers", "bwd_begin"), ("towers", "bwd_end"), ("bank", "bwd_begin"), ("bank", "bwd_end")]
    return events, labels


def test_layers_busy_window_and_gaps():
    events, labels = window()
    s = T.analyse(events, labels, steps=1)
    assert s["markers"] == 8
    assert s["layer_ms"]["bank"] == pytest.approx((50 + 100) / 1e3)
    assert s["layer_ms"]["towers"] == pytest.approx((200 + 300) / 1e3)
    assert s["busy_s"] == pytest.approx((50 + 200 + 300 + 100 + 46) / 1e6)
    assert s["window_s"] == pytest.approx(1000 / 1e6)
    gaps = dict((round(g * 1e6), label) for label, g in s["idle_gaps"])
    assert gaps[101] == "dispatch"  # 0-101 (markers are not work), under the dispatch span
    assert gaps[150] == "loss_read"  # 850-1000
    assert gaps[48] == "other"  # 353-401
    assert [name for name, _ in s["device_ops"]][:2] == ["gemm_dx", "gemm"]
    assert all(not name.startswith(("pb:", "spin_kernel")) for name, _ in s["device_ops"])


def test_completeness_refuses_a_dropped_event():
    events, labels = window()
    book = {"labels": labels, "steps": 1, "launches": 2}
    assert T.check_complete(events, book, {"bank_fwd_kernel", "bank_bwd_kernel"})[0]
    dropped, _ = window(drop_k1=True)
    ok, why = T.check_complete(dropped, book, {"bank_fwd_kernel", "bank_bwd_kernel"})
    assert not ok and why["bank"] == 1
    no_marker = [e for e in events if not (e.name == "spin_kernel" and e.time_range.start == 400)]
    assert not T.check_complete(no_marker, book, {"bank_fwd_kernel", "bank_bwd_kernel"})[0]


def test_readers_on_the_summary():
    from types import SimpleNamespace

    from portbench.harness import cell as C

    events, labels = window()
    s = T.analyse(events, labels, steps=1)
    s["jittered"] = [[10]]
    # an untraced window of 1,200 steps in 1 s: 0.833 ms a step, 0.696 ms of it busy
    run = SimpleNamespace(prog=SimpleNamespace(trace=s, attempted=1200, window_s=1.0), settings={
        "towers": {"T": {"image_resolution": 32}}, "clip_models": ["T"], "num_cuts": 16})
    run.trace = s
    assert C.reader("device_idle_pct.steady").read(run) == pytest.approx(100 * (1 - 696e-6 * 1200))
    run.trace = None
    assert C.reader("device_idle_pct.steady").read(run) is None  # no traced walk: nothing to read
    run.trace = s
    assert C.reader("towers_ms").read(run) == pytest.approx(0.5)
    assert C.reader("decoder_ms").read(run) is None  # no decoder markers: nothing to read
    from portbench.harness.counts import bank_bound_s

    assert C.reader("bank_roofline").read(run) == pytest.approx(
        100 * 1e3 * sum(bank_bound_s(16, 10, 32, (32, 32))) / 0.15)


def test_run_readers_on_the_summary():
    """``checkin_ms`` from the program's ``checkin`` span over the walk; ``device_idle_pct.run`` as the steady one."""
    from types import SimpleNamespace

    from portbench.harness import cell as C

    events, labels = window()
    s = T.analyse(events, labels, steps=1)
    s["spans"] = {"checkin": {"s": 0.17, "n": 2}, "block.dispatch": {"s": 0.01, "n": 2}}
    run = SimpleNamespace(prog=SimpleNamespace(trace=s, attempted=1200, window_s=1.0), trace=s)
    assert C.reader("checkin_ms").read(run) == pytest.approx(85.0)
    assert C.reader("device_idle_pct.run").read(run) == C.reader("device_idle_pct.steady").read(run)
    s["spans"] = {}  # a walk without a checkin
    assert C.reader("checkin_ms").read(run) is None
    run.trace = None
    assert C.reader("checkin_ms").read(run) is None
    assert C.reader("device_idle_pct.run").read(run) is None
