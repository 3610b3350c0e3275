"""The port runs with JAX, flax, optax and pixray_tpu unimportable — as on a
GPU machine that has none of them.  PIL, PyYAML, regex, ftfy and matplotlib
are blocked too: the port's main path must not need them (the palette DSL
resolves colour names from its checked-in tables).

A subprocess installs an import hook that refuses those modules, imports
pixray_tpu_torch and runs a slice for 2 steps on the CPU at TinyTest size
through the public API: the pixel slice, the clipdraw slice with its
SVG export, and the vqgan slice (tiny_test, random weights, two towers) at
a size on the VQGAN's grid, so the init noise needs no resize (and no PIL).
Then a blocked pixel run (10 steps: steps 1-8 one block), the step
video's GIF branch (PIL allowed, imageio refused, no ffmpeg), and the
plug-ins: the fft drawer (dwt, blocked, and fft) under the wallpaper filter
with custom losses, and fast_pixel under lookup and tiler with the other
losses and a palette of colour names.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import shutil
    import sys

    shutil.which = lambda *a, **k: None  # no ffmpeg

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import pixray_tpu_torch as pixray

    pixray.reset_settings()
    pixray.add_settings(**dict(dict(prompts="sunrise", clip_models="TinyTest", size=[64, 36],
                                    num_cuts=8, iterations=2, save_every=1, seed=3, outdir=OUTDIR,
                                    save_intermediates=False, learning_rate_drops=[],
                                    vector_prompts="none"), **DRAWER))
    settings = pixray.apply_settings()
    pixray.do_init(settings, device="cpu")
    assert pixray.do_run(settings)
    assert (pixray.get_engine().step_block is not None) == EXPECT_BLOCK
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex", "pixray_tpu", "PIL", "yaml", "regex", "ftfy", "matplotlib")


def _run_blocked(tmp_path, drawer: dict, blocked=BLOCKED, expect_block=False):
    outdir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO)
    head = f"OUTDIR = {outdir!r}\nDRAWER = {drawer!r}\nBLOCKED = {blocked!r}\nEXPECT_BLOCK = {expect_block!r}\n"
    proc = subprocess.run(
        [sys.executable, "-c", head + SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
    assert f"iter: {drawer.get('iterations', 2)}" in proc.stdout  # the final checkin
    with open(os.path.join(outdir, "output.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    return outdir, proc.stdout


def test_port_runs_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="pixel"))


def test_clipdraw_runs_without_jax(tmp_path):
    outdir, _ = _run_blocked(tmp_path, dict(drawer="clipdraw", strokes=12, save_svg=True))
    with open(os.path.join(outdir, "output.svg")) as f:
        assert f.read().count("<path ") == 12


def test_vqgan_runs_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="vqgan", vqgan_model="tiny_test", clip_models="TinyTest,TinyTest48"))


def test_blocked_run_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="pixel", iterations=10, save_every=100), expect_block=True)


def test_step_video_gif_without_jax(tmp_path):
    blocked = tuple(m for m in BLOCKED if m != "PIL") + ("imageio",)
    outdir, stdout = _run_blocked(tmp_path, dict(drawer="pixel", save_intermediates=True), blocked=blocked)
    assert sorted(os.listdir(os.path.join(outdir, "steps"))) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png", "output.gif"]
    assert "WARNING: no MP4 encoder available" in stdout


def test_fft_plugins_run_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="fft", fft_use="dwt", filters="wallpaper", wallpaper_type="shift",
                                custom_loss="smoothness:0.5,saturation", iterations=10, save_every=100),
                 expect_block=True)


def test_fft_mode_runs_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="fft", init_noise="none", filters="tiler"))


def test_fast_pixel_plugins_run_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="fast_pixel", filters="lookup,tiler:0.5", palette="red->sky blue\\8;mat:teal",
                                custom_loss="symmetry,palette,gaussian,edge,aesthetic"))
