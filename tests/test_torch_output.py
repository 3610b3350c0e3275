"""The port's step video (``io/output.py`` ``step_to_video``) against the JAX
package's, ``run``'s ending after an interrupt, and the run's other
outputs against the JAX engine's, on the CPU.

ffmpeg is taken off PATH and imageio made unimportable, so both packages
take their last branch: a GIF beside the MP4 name, with a warning.  The
frames are PNGs the test writes; the two GIFs must hold the same number of
frames at the same duration per frame.

One run of each engine (pixel, TinyTest, 6 steps) with ``--make_video``,
``--profile_dir`` and ``run(return_display=True)``, ``display_every`` 2:
``run`` returns False at the same steps (2, 4, 6) and then True; the
per-step frames ``video/frame_0000-0005.png`` and the video of frames 1-5
(``output.gif`` here) as the JAX engine writes them.  The port's
``--profile_dir`` trace (a Chrome trace, ``trace.json``, of the run's
ops) is written by the first call only, as the JAX engine traces only a
run that starts at step 0 (the JAX engine runs without one here: tracing
its compile takes ~45 s on the CPU).  ``PhaseTimer`` as the JAX
package's.
"""

import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.engine.profiling import PhaseTimer as JPhaseTimer
from pixray_tpu.io import output as j_output
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.profiling import TRACE_FILE, PhaseTimer
from pixray_tpu_torch.io import output as OUT
from torch_parity import jax_perceptor_cache  # noqa: F401


@pytest.fixture
def no_encoders(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    monkeypatch.setitem(sys.modules, "imageio", None)


def _frames(outdir, count):
    steps = outdir / "steps"
    steps.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(count):
        OUT.save_png(rng.random((18, 32, 3)), str(steps / f"frame_{10 * i:04d}.png"))


@pytest.mark.parametrize("count", [3, 300])
def test_step_video_gif_matches_jax(tmp_path, capsys, no_encoders, count):
    for label in ("jax", "port"):
        _frames(tmp_path / label, count)
    j_output.step_to_video(SimpleNamespace(outdir=str(tmp_path / "jax")))
    jax_out = capsys.readouterr().out
    OUT.step_to_video(SimpleNamespace(outdir=str(tmp_path / "port")))
    port_out = capsys.readouterr().out
    gifs = {}
    for label in ("jax", "port"):
        path = tmp_path / label / "steps" / "output.gif"
        assert path.exists() and not (tmp_path / label / "steps" / "output.mp4").exists()
        with Image.open(path) as im:
            gifs[label] = (im.n_frames, im.info["duration"])
    assert gifs["port"] == gifs["jax"]
    assert gifs["port"][0] == count
    assert gifs["port"][1] == int(1000 / OUT._clip_fps(count)) // 10 * 10  # GIF keeps centiseconds
    for out in (jax_out, port_out):
        assert "WARNING: no MP4 encoder available" in out and "output.gif instead" in out


def test_step_video_without_frames(tmp_path, no_encoders):
    (tmp_path / "steps").mkdir()
    OUT.step_to_video(SimpleNamespace(outdir=str(tmp_path)))
    assert os.listdir(tmp_path / "steps") == []


def test_interrupted_run_writes_video_and_svg(tmp_path, monkeypatch, no_encoders):
    settings = dict(drawer="clipdraw", strokes=6, prompts="sunrise", clip_models="TinyTest", size=[64, 36],
                    num_cuts=4, iterations=20, save_every=2, seed=2, outdir=str(tmp_path),
                    learning_rate_drops=[], vector_prompts="none", save_svg=True)
    engine = Engine(apply_settings(settings, apply_side_effects=False), device="cpu")
    assert engine.args.save_intermediates  # the default
    train = engine.train

    def interrupted(it, draws=None):
        if it == 5:
            raise KeyboardInterrupt
        return train(it, draws)

    monkeypatch.setattr(engine, "train", interrupted)
    assert engine.run()
    assert engine.cur_iteration == 5
    frames = sorted(os.listdir(tmp_path / "steps"))
    assert frames == ["frame_0000.png", "frame_0002.png", "frame_0004.png", "output.gif"]
    with Image.open(tmp_path / "steps" / "output.gif") as im:
        assert im.n_frames == 3
    assert (tmp_path / "output.svg").read_text().count("<path ") == 6


def _streamed(engine):
    """``run(return_display=True)`` until it returns True: (result, cur_iteration) per call."""
    calls = []
    while not calls or not calls[-1][0]:
        calls.append((engine.run(return_display=True), engine.cur_iteration))
        assert len(calls) < 10
    return calls


@pytest.mark.usefixtures("jax_perceptor_cache")
def test_video_trace_and_streaming_match_jax(tmp_path, capsys, no_encoders):
    settings = dict(drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[48, 32], num_cuts=4,
                    iterations=6, save_every=3, display_every=2, seed=2, learning_rate_drops=[],
                    vector_prompts="none", precision="fp32", save_intermediates=False, make_video=True)
    runs = {}
    for label, (apply, make) in (("jax", (j_apply_settings, JEngine)),
                                 ("port", (apply_settings, lambda a: Engine(a, device="cpu")))):
        outdir = tmp_path / label
        outdir.mkdir()
        profile_dir = str(outdir / "prof") if label == "port" else None
        engine = make(apply(dict(settings, outdir=str(outdir), profile_dir=profile_dir), apply_side_effects=False))
        runs[label] = (engine, _streamed(engine), capsys.readouterr().out)
    assert runs["port"][1] == runs["jax"][1] == [(False, 2), (False, 4), (False, 6), (True, 6)]
    for label in ("jax", "port"):
        outdir = tmp_path / label
        assert sorted(os.listdir(outdir / "video")) == [f"frame_{i:04d}.png" for i in range(6)]
        with Image.open(outdir / "video" / "frame_0003.png") as im:
            assert im.size == (48, 32) and im.mode == "RGB"
        assert (outdir / "output.gif").exists() and not (outdir / "output.mp4").exists()
        assert "WARNING: no MP4 encoder available" in runs[label][2]
    assert runs["port"][2].count("wrote torch profiler trace") == 1  # the first call only
    with Image.open(tmp_path / "jax" / "output.gif") as a, Image.open(tmp_path / "port" / "output.gif") as b:
        assert (b.n_frames, b.info["duration"]) == (a.n_frames, a.info["duration"]) == (5, 100)
    assert os.listdir(tmp_path / "port" / "prof") == [TRACE_FILE]
    with open(tmp_path / "port" / "prof" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_phase_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    reports = []
    for timer in (JPhaseTimer(), PhaseTimer()):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        for name in ("draw", "step", "draw"):
            with timer.phase(name):
                pass
        reports.append(timer.report())
    assert reports[0] == reports[1] == "step: 0.500s total / 1 calls = 500.00 ms\ndraw: 0.375s total / 2 calls = 187.50 ms"
