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
losses and a palette of colour names.  Then the image slice (PIL allowed,
the rest refused), blocked: an init image, an overlay, image prompts,
spot prompts, a target image, labels and an image label on the vqgan
drawer; the runs above, without images, import no PIL.  Then the rest of
the engine: AdamP under ``--checkpoint_every`` and ``--profile_dir``,
streamed (``do_run(settings, return_display=True)`` until it returns
True), and a second run resumed from its checkpoint; ``--make_video``
(PIL allowed for the GIF, imageio refused); the animation ring over init,
prompt and target image globs (PIL allowed).  Then the two other tower
kinds, blocked: a tiny ModifiedResNet and a tiny timm (SLIP-style) trunk,
put into the port's config tables by the subprocess, beside TinyTest.
Then the pixel drawer's SVG export, a ``tiny_up`` vdiff run (eager,
re-noised after every step) and a super_resolution run (a tiny RRDBNet
from a basicsr file on disk, blocked).  Then a hex pixel run with the
``resmem`` and ``style`` losses (PIL allowed: the style file).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from torch_parity import TINY_CLIP, TINY_SLIP

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
    exec(SETUP)

    pixray.reset_settings()
    pixray.add_settings(**dict(dict(prompts="sunrise", clip_models="TinyTest", size=[64, 36],
                                    num_cuts=8, iterations=2, save_every=1, seed=3, outdir=OUTDIR,
                                    save_intermediates=False, learning_rate_drops=[],
                                    vector_prompts="none"), **DRAWER))
    settings = pixray.apply_settings()
    pixray.do_init(settings, device="cpu")
    while not pixray.do_run(settings, return_display=STREAM):
        pass
    assert (pixray.get_engine().step_block is not None) == EXPECT_BLOCK
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex", "pixray_tpu", "PIL", "yaml", "regex", "ftfy", "matplotlib")


def _run_blocked(tmp_path, drawer: dict, blocked=BLOCKED, expect_block=False, stream=False, final_checkin=True,
                 setup=""):
    outdir = str(tmp_path / "run")
    # the subprocess takes the worker's share of the cores (tests/torch_parity.py)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(torch.get_num_threads()))
    head = (f"OUTDIR = {outdir!r}\nDRAWER = {drawer!r}\nBLOCKED = {blocked!r}\nEXPECT_BLOCK = {expect_block!r}\n"
            f"STREAM = {stream!r}\nSETUP = {setup!r}\n")
    proc = subprocess.run(
        [sys.executable, "-c", head + SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
    if not final_checkin:  # the animation writes its frames' PNGs instead
        return outdir, proc.stdout
    assert f"iter: {drawer.get('iterations', 2)}" in proc.stdout  # the final checkin
    with open(os.path.join(outdir, "output.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    return outdir, proc.stdout


def test_port_runs_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="pixel"))


def test_pixel_svg_without_jax(tmp_path):
    outdir, _ = _run_blocked(tmp_path, dict(drawer="pixel", pixel_size=[16, 9], save_svg=True))
    with open(os.path.join(outdir, "output.svg")) as f:
        assert f.read().count("<polygon ") == 16 * 9


def test_vdiff_runs_without_jax(tmp_path):
    """tiny_up (random weights, the generated canvas 128x128): every step
    eager, each re-noised after it from step 1 on."""
    _, stdout = _run_blocked(tmp_path, dict(drawer="vdiff", vdiff_model="tiny_up", vdiff_schedule="log"))
    assert "WARNING: v-diffusion weights for tiny_up not found" in stdout


# a tiny RRDBNet checkpoint in basicsr's layout, written by the subprocess
# where the drawer looks for one (the full 23 blocks crawl on a loaded CPU)
TINY_RRDBNET = (
    "import os, torch\n"
    "from pixray_tpu_torch.models.esrgan import RRDBNet, init_random_\n"
    "os.environ['PIXRAY_TPU_MODELS'] = os.getcwd()\n"
    "net = init_random_(RRDBNet(num_feat=16, num_block=1, num_grow_ch=8), torch.Generator().manual_seed(0))\n"
    "torch.save({'params_ema': net.state_dict()}, 'super_resolution_RealESRGAN_x4plus.ckpt')\n")


def test_super_resolution_runs_without_jax(tmp_path):
    """A tiny RRDBNet read from a basicsr file on disk, a 16x9 latent, blocked."""
    _, stdout = _run_blocked(tmp_path, dict(drawer="super_resolution", iterations=10, save_every=100),
                             expect_block=True, setup=TINY_RRDBNET)
    assert "Loaded RealESRGAN from" in stdout


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


def test_image_slice_runs_without_jax(tmp_path):
    from PIL import Image

    paths = {}
    for i, (name, shape, mode) in enumerate((("init", (36, 64, 3), "RGB"), ("overlay", (20, 30, 4), "RGBA"),
                                             ("prompt", (30, 30, 3), "RGB"), ("target", (40, 33, 3), "RGB"))):
        paths[name] = str(tmp_path / f"{name}.png")
        Image.fromarray(np.random.default_rng(i).integers(0, 256, shape, dtype=np.uint8), mode).save(paths[name])
    blocked = tuple(m for m in BLOCKED if m != "PIL")
    _, stdout = _run_blocked(tmp_path, dict(
        drawer="vqgan", vqgan_model="tiny_test", iterations=10, save_every=100, init_image=paths["init"],
        init_weight_pix=0.5, overlay_image=paths["overlay"], overlay_every=9, image_prompts=paths["prompt"],
        spot_prompts="a face", spot_prompts_off="sky", target_images=paths["target"], labels="fox",
        image_labels=paths["init"]), blocked=blocked, expect_block=True)
    assert "Using image prompts" in stdout and "Using initial image" in stdout


def test_optimizer_checkpoint_trace_and_resume_without_jax(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    first, stdout = _run_blocked(tmp_path / "a", dict(drawer="pixel", optimiser="AdamP", iterations=4,
                                                      checkpoint_every=2, display_every=2,
                                                      profile_dir=str(tmp_path / "prof")), stream=True)
    assert os.listdir(tmp_path / "prof") == ["trace.json"] and "wrote torch profiler trace" in stdout
    ckpt = os.path.join(first, "session.ckpt")
    _, stdout = _run_blocked(tmp_path / "b", dict(drawer="pixel", optimiser="AdamP", iterations=4, resume_from=ckpt))
    assert "Resumed session from" in stdout and "at iteration 3" in stdout


def test_make_video_without_jax(tmp_path):
    blocked = tuple(m for m in BLOCKED if m != "PIL") + ("imageio",)
    outdir, stdout = _run_blocked(tmp_path, dict(drawer="pixel", iterations=4, make_video=True), blocked=blocked)
    assert sorted(os.listdir(os.path.join(outdir, "video"))) == [f"frame_{i:04d}.png" for i in range(4)]
    assert os.path.exists(os.path.join(outdir, "output.gif")) and "WARNING: no MP4 encoder available" in stdout


def test_animation_without_jax(tmp_path):
    from PIL import Image

    for kind in ("init", "prompt", "target"):
        for i in range(2):
            arr = np.random.default_rng(i).integers(0, 256, (30, 40, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / f"{kind}{i}.png")
    blocked = tuple(m for m in BLOCKED if m != "PIL")
    anim = str(tmp_path / "anim")
    _, stdout = _run_blocked(tmp_path, dict(
        drawer="pixel", iterations=4, save_every=2, animation_dir=anim, init_image=str(tmp_path / "init*.png"),
        image_prompts=str(tmp_path / "prompt*.png"), target_images=str(tmp_path / "target*.png")),
        blocked=blocked, final_checkin=False)
    assert sorted(os.listdir(anim)) == ["anim.gif", "target0.png", "target1.png"]
    assert "anim: 1/2 iter: 2" in stdout


# the tiny towers of tests/torch_parity.py, put into the port's tables in the subprocess
TINY_TOWERS = "from pixray_tpu_torch.models.clip import configs as cfg\n" + "".join(
    f"cfg.{table}[{name!r}] = cfg.CLIPConfig(**{fields!r})\n"
    for table, towers in (("CLIP_CONFIGS", TINY_CLIP), ("SLIP_CONFIGS", TINY_SLIP)) for name, fields in towers.items())


def test_resnet_and_timm_towers_run_without_jax(tmp_path):
    _, stdout = _run_blocked(tmp_path, dict(drawer="pixel", clip_models="TinyRN,TinyTimm48,TinyTest", iterations=10,
                                            save_every=100), expect_block=True, setup=TINY_TOWERS)
    assert "losses: " in stdout and stdout.count("WARNING: no checkpoint found for perceptor") == 3


def test_hex_style_resmem_run_without_jax(tmp_path):
    """Two steps of a hex pixel run with ``resmem`` and ``style`` (PIL
    allowed: the style file is read through ``io/images.py``); the style
    loss's blocked path is tests/test_torch_style.py's."""
    from PIL import Image

    style = str(tmp_path / "style.png")
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(style)
    blocked = tuple(m for m in BLOCKED if m != "PIL")
    _, stdout = _run_blocked(tmp_path, dict(drawer="pixel", pixel_type="hex", custom_loss="resmem,style",
                                            styleloss_skip=0, style_file=style),
                             blocked=blocked)
    assert "WARNING: VGG16 weights not found" in stdout and "WARNING: ResMem weights not found" in stdout
