"""The port's step video (``io/output.py`` ``step_to_video``) against the JAX
package's, and ``run``'s ending after an interrupt, on the CPU.

ffmpeg is taken off PATH and imageio made unimportable, so both packages
take their last branch: a GIF beside the MP4 name, with a warning.  The
frames are PNGs the test writes; the two GIFs must hold the same number of
frames at the same duration per frame.
"""

import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from pixray_tpu.io import output as j_output
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.io import output as OUT


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
