"""The port's registry, YAML runner and Cog products against the JAX package.

- registry: the same names in the three tables as ``pixray_tpu.registry``,
  every module loaded with no soft-fail note, ``add_custom_loss``;
- products, settings: for each of the ten products on seeded inputs, the
  settings handed to ``apply_settings`` (base YAML + kwargs + skip_args)
  equal the JAX product's, and the resolved namespaces agree on their
  shared keys (exactly: host-side parsing, no tolerance);
- products, stream: ``PixrayApi`` (TinyTest, fast_pixel, 64x36, 4 single
  steps, which keeps the JAX side to one compiled step, ``display_every``
  2) yields as many frames as the JAX product, each its own decodable
  PNG, whose pixels are bitwise the port's own ``run(return_display=True)``
  from the same seed, also when the package's current engine is replaced
  between two frames;
- the temporary copies: two frames copied in turn stay two files.

The YAML runner module is run in a subprocess only: importing it binds
``pixray_tpu_torch.run`` to the module (its docstring says why).
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import pixray_tpu
import pixray_tpu.serve.predictors as JP
import pixray_tpu_torch
import pixray_tpu_torch.serve.predictors as P
from pixray_tpu import registry as jregistry
from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu_torch import registry
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.losses.base import LossInterface
from torch_parity import jax_perceptor_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_registry_loads_every_module_without_a_note():
    out = io.StringIO()
    with redirect_stdout(out):
        registry.load_registries()
        registry.load_registries()
    assert out.getvalue() == ""
    assert len(registry.DRAWER_CLASSES) == 8 and len(registry.LOSS_CLASSES) == 9
    assert len(registry.FILTER_CLASSES) == 3
    jregistry.load_registries()
    for port, jax_table in ((registry.DRAWER_CLASSES, jregistry.DRAWER_CLASSES),
                            (registry.LOSS_CLASSES, jregistry.LOSS_CLASSES),
                            (registry.FILTER_CLASSES, jregistry.FILTER_CLASSES)):
        assert sorted(port) == sorted(jax_table)
        assert {k: v.__name__ for k, v in port.items()} == {k: v.__name__ for k, v in jax_table.items()}


def test_add_custom_loss_round_trips(monkeypatch):
    class Constant(LossInterface):
        def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
            return out.sum() * 0

    monkeypatch.delitem(registry.LOSS_CLASSES, "frontends_test_loss", raising=False)
    pixray_tpu_torch.add_custom_loss("frontends_test_loss", Constant)
    assert registry.loss_class("frontends_test_loss") is Constant
    settings = apply_settings(dict(drawer="pixel", prompts="x", custom_loss="frontends_test_loss:0.5"),
                              apply_side_effects=False)
    assert settings.custom_loss == "frontends_test_loss:0.5"
    with pytest.raises(TypeError):
        pixray_tpu_torch.add_custom_loss("not_a_loss", dict)
    registry.LOSS_CLASSES.pop("frontends_test_loss")


def test_command_line_override(monkeypatch, tmp_path):
    argv = ["pixray", "--drawer", "pixel", "--prompts", "a barn", "--clip_models", "TinyTest", "--seed", "4",
            "--outdir", str(tmp_path / "out")]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.chdir(tmp_path)
    port = vars(pixray_tpu_torch.command_line_override())
    ref = vars(pixray_tpu.command_line_override())
    assert port == ref


class _Captured(Exception):
    pass


def _handed_settings(module, predictor, monkeypatch, **kwargs):
    """The settings the product hands to ``apply_settings``."""
    seen = {}

    def capture():
        seen.update(module.get_settings())
        raise _Captured

    monkeypatch.setattr(module, "apply_settings", capture)
    with pytest.raises(_Captured):
        next(iter(predictor.predict(**kwargs)))
    return seen


WORDS = ["sunrise", "a red barn", "lighthouse at night", "#pixelart", "Cairo skyline", "a fox"]


def _cases():
    rng = np.random.default_rng(13)
    words = lambda: " ".join(rng.choice(WORDS, 2))
    return [
        ("text2image", dict(prompts=words(), drawer="pixel", settings="iterations: 7\nseed: 3\n")),
        ("pixray_vqgan", dict(prompts=words(), quality="draft", aspect="square")),
        ("pixray_pixel", dict(prompts=words(), aspect="portrait")),
        ("text2pixel", dict(prompts=words(), aspect="widescreen", pixel_scale=1.5)),
        ("pixrayraw", dict(prompts=words(), settings="drawer: fft\nfft_use: dwt\n")),
        ("pixrayapi", dict(settings=f"prompts: {words()}\ndrawer: clipdraw\nstrokes: 64\n")),
        ("tiler", dict(prompts=words(), pixelart=False, mirror=False)),
        ("tiler", dict(prompts=words(), pixelart=False, mirror=True)),
        ("tiler", dict(prompts=words(), pixelart=True, mirror=False)),
        ("tiler", dict(prompts=words(), pixelart=True, mirror=True, settings="iterations: 11\n")),
        ("pixray_vdiff", dict(prompts=words(), settings="vdiff_model: cc12m_1\n")),
        ("8bidg", dict(prompts=words(), palette="grayscale", border="none")),
        ("8bidg", dict(prompts=words(), palette="full color", border="red")),
        ("genesis", dict(title="", quality="draft")),
        ("genesis", dict(title=words(), quality="best", optional_settings="drawer: pixel\npixel_size: [40, 30]\n")),
    ]


@pytest.mark.parametrize("product,kwargs", _cases())
def test_products_hand_the_jax_settings(product, kwargs, monkeypatch):
    assert sorted(P.PRODUCTS) == sorted(JP.PRODUCTS)
    port = _handed_settings(pixray_tpu_torch, P.PRODUCTS[product](device="cpu"), monkeypatch, **kwargs)
    ref = _handed_settings(pixray_tpu, JP.PRODUCTS[product](), monkeypatch, **kwargs)
    assert port == ref and port["skip_args"] is True
    port_ns = vars(apply_settings(dict(port), apply_side_effects=False))
    ref_ns = vars(j_apply_settings(dict(ref), apply_side_effects=False))
    shared = port_ns.keys() & ref_ns.keys()
    assert len(shared) > 0.9 * len(ref_ns)
    assert {k: port_ns[k] for k in shared} == {k: ref_ns[k] for k in shared}


def test_cogs_dir_follows_the_environment(tmp_path):
    code = "import pixray_tpu_torch.serve.predictors as P; print(P.COGS_DIR)"
    env = dict(os.environ, PYTHONPATH=REPO, PIXRAY_TPU_COGS=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path), out.stderr
    if "PIXRAY_TPU_COGS" not in os.environ:
        assert P.COGS_DIR == os.path.join(REPO, "cogs")


def test_temporary_copies_stay_distinct(tmp_path):
    """Each frame is a file of its own: a second copy does not overwrite the first."""
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    a.write_bytes(b"first frame")
    b.write_bytes(b"second frame")
    pa, pb = P.create_temporary_copy(str(a)), P.create_temporary_copy(str(b))
    try:
        assert pa != pb and pa.endswith(".png")
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert (fa.read(), fb.read()) == (b"first frame", b"second frame")
    finally:
        os.remove(pa)
        os.remove(pb)


STREAM = dict(drawer="fast_pixel", prompts="a test prompt", clip_models="TinyTest", size=[64, 36], iterations=4,
              save_every=2, display_every=2, init_noise="pixels", vector_prompts="none", num_cuts=4, batches=1,
              seed=42, save_intermediates=False, learning_rate_drops=[], steps_per_call=1)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.usefixtures("jax_perceptor_cache")
def test_pixrayapi_streams_like_jax(tmp_path, monkeypatch):
    cogs = tmp_path / "cogs"
    cogs.mkdir()
    (cogs / "pixrayapi.yaml").write_text(yaml.dump(dict(STREAM, outdir=str(tmp_path / "api"))))
    monkeypatch.setattr(P, "COGS_DIR", str(cogs))
    monkeypatch.setattr(JP, "COGS_DIR", str(cogs))

    stream = P.PixrayApi(device="cpu").predict(settings="\n")
    frames = [str(next(stream))]
    # another job's do_init (one abandoned past its deadline, say) replaces
    # the package's current engine: this stream keeps running its own
    monkeypatch.setattr(pixray_tpu_torch, "_engine", None)
    frames += [str(p) for p in stream]
    ref_frames = [str(p) for p in JP.PixrayApi().predict(settings="\n")]
    assert len(frames) == len(ref_frames) >= 2
    assert len(set(frames)) == len(frames)

    # the port's own streamed run from the same settings
    pixray_tpu_torch.reset_settings()
    pixray_tpu_torch.add_settings(**dict(STREAM, outdir=str(tmp_path / "direct")))
    resolved = pixray_tpu_torch.apply_settings()
    pixray_tpu_torch.do_init(resolved, device="cpu")
    direct, complete = [], False
    while not complete:
        complete = pixray_tpu_torch.do_run(resolved, return_display=True)
        direct.append(_pixels(os.path.join(resolved.outdir, resolved.output)))
    try:
        assert len(direct) == len(frames)
        for path, want in zip(frames, direct):
            with open(path, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"
            np.testing.assert_array_equal(_pixels(path), want)
        assert not np.array_equal(direct[0], direct[-1])  # the frames move with the run
    finally:
        for path in frames:
            os.remove(path)


def test_predictor_runs_on_the_given_device(monkeypatch, tmp_path):
    """The product passes its device to ``do_init``; the default is the card."""
    seen = []

    class Stop(Exception):
        pass

    def do_init(resolved, device="cuda"):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(pixray_tpu_torch, "do_init", do_init)
    monkeypatch.setattr(P, "COGS_DIR", os.path.join(REPO, "cogs"))
    monkeypatch.chdir(tmp_path)  # the settings' side effects make the YAML's outdir
    for product in (P.PixrayApi(), P.PixrayApi(device="cpu"), P.GenesisPredictor(device=torch.device("cpu"))):
        with pytest.raises(Stop):
            next(iter(product.predict()))
    assert seen == ["cuda", "cpu", torch.device("cpu")]
