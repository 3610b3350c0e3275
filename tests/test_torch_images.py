"""The port's image inputs against the JAX package on the CPU, bitwise
(both run the same PIL and numpy operations on the same files):

- ``io/images.py``'s helpers on RGB and RGBA PNGs the test writes;
- ``load_spot_mask`` with each of the package's two assets (square and
  wide), with a ``spot_file``, and with the procedural mask where the
  asset is missing; the port's asset files are the JAX package's;
- ``--aspect retain`` sizes from the first init image;
- ``--init_noise gradient`` and ``snow`` images from one
  ``np.random.Generator`` state;
- the init tensor the engines hand their drawer (``--init_image`` with
  ``--init_image_alpha``, the noise kinds, white for any other
  ``--init_noise``) and the init images pasted over the noise.
"""

import os

import numpy as np
import pytest
from PIL import Image

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.drawers.pixel import PixelDrawer as JPixel
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.io import images as JIM
from pixray_tpu.utils import noise as jnoise
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.drawers.pixel import PixelDrawer
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.io import images as IM
from pixray_tpu_torch.utils import noise
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_png(path, shape, mode, seed):
    arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    Image.fromarray(arr, mode).save(path)
    return str(path)


@pytest.fixture
def pngs(tmp_path):
    return {"rgb": write_png(tmp_path / "rgb.png", (37, 58, 3), "RGB", 1),
            "rgba": write_png(tmp_path / "rgba.png", (50, 31, 4), "RGBA", 2)}


@pytest.mark.parametrize("kind", ["rgb", "rgba"])
def test_image_helpers_match_jax(pngs, kind):
    path = pngs[kind]
    port, ref = IM.open_image(path), JIM.open_image(path)
    assert port.mode == ref.mode and port.size == ref.size
    np.testing.assert_array_equal(IM.to_tensor(port), JIM.to_tensor(ref))
    assert IM.to_tensor(port).dtype == np.float32
    arr = np.random.default_rng(3).uniform(-0.2, 1.2, IM.to_tensor(port).shape).astype(np.float32)
    got, want = IM.from_tensor(arr), JIM.from_tensor(arr)
    assert got.mode == want.mode
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for size in ((48, 32), (200, 90)):
        np.testing.assert_array_equal(np.asarray(IM.resize_area_preserving(port, size)),
                                      np.asarray(JIM.resize_area_preserving(ref, size)))
        np.testing.assert_array_equal(IM.load_image_rgb(path, size), JIM.load_image_rgb(path, size))
    for resolution in (32, 48):
        got = IM.load_image_for_perceptor(path, resolution)
        assert got.shape == (resolution, resolution, 3)
        np.testing.assert_array_equal(got, JIM.load_image_for_perceptor(path, resolution))
    assert [im.size for im in IM.open_images(os.path.join(os.path.dirname(path), "*.png"))] == [
        im.size for im in JIM.open_images(os.path.join(os.path.dirname(path), "*.png"))]


def test_spot_assets_are_the_jax_packages():
    for name in ("spot_square.png", "spot_wide.png"):
        with open(os.path.join(IM.ASSETS, name), "rb") as a, \
                open(os.path.join(REPO, "pixray_tpu", "assets", "inputs", name), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("size,aspect", [(32, 1.0), (48, 16 / 9), (224, 384 / 216), (40, 0.75)])
def test_spot_mask_matches_jax(tmp_path, monkeypatch, size, aspect):
    got = IM.load_spot_mask(None, size, aspect)  # the package's asset for this aspect
    np.testing.assert_array_equal(got, JIM.load_spot_mask(None, size, aspect))
    assert got.shape == (size, size) and 0 < got.mean() < 1
    spot_file = write_png(tmp_path / "spot.png", (60, 90), "L", 4)
    np.testing.assert_array_equal(IM.load_spot_mask(spot_file, size, aspect),
                                  JIM.load_spot_mask(spot_file, size, aspect))
    # no asset: the procedural mask
    monkeypatch.setattr(IM, "builtin_spot_asset", lambda aspect: None)
    monkeypatch.setattr(JIM, "_builtin_spot_asset", lambda aspect: None)
    np.testing.assert_array_equal(IM.load_spot_mask(None, size, aspect), JIM.load_spot_mask(None, size, aspect))
    np.testing.assert_array_equal(IM.load_spot_mask(None, size, aspect), IM.default_spot_mask(size, aspect))


@pytest.mark.parametrize("kind", ["rgb", "rgba"])
@pytest.mark.parametrize("extra", [dict(), dict(quality="better"), dict(ezsize="small", scale=None)])
def test_aspect_retain_sizes_match_jax(pngs, kind, extra):
    settings = dict(prompts="x", drawer="pixel", aspect="retain", init_image=pngs[kind], **extra)
    port = vars(apply_settings(dict(settings), apply_side_effects=False))
    ref = vars(j_apply_settings(dict(settings), apply_side_effects=False))
    assert port == ref
    w, h = Image.open(pngs[kind]).size
    assert port["size"][1] == int(144 * (h / w) * (port["size"][0] / 144))


@pytest.mark.parametrize("w,h", [(48, 32), (97, 61)])
def test_gradient_and_snow_match_jax(w, h):
    for port_fn, ref_fn in ((noise.random_gradient_array, jnoise.random_gradient_image),
                            (noise.old_random_noise_array, jnoise.old_random_noise_image)):
        rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
        got = port_fn(w, h, rng_a)
        want = np.asarray(ref_fn(w, h, rng_b))
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)
        assert rng_a.random() == rng_b.random()  # the same draws taken


def _record_init_tensor(monkeypatch):
    """The init tensors the two engines hand the pixel drawer."""
    seen = {}
    port_init, ref_init = PixelDrawer.init_params, JPixel.init_params

    def port(self, gen, init_tensor=None, **kw):
        seen["port"] = None if init_tensor is None else init_tensor.clone()
        return port_init(self, gen, init_tensor, **kw)

    def ref(self, key, init_tensor=None, *a, **kw):
        seen["jax"] = None if init_tensor is None else np.asarray(init_tensor)
        return ref_init(self, key, init_tensor, *a, **kw)

    monkeypatch.setattr(PixelDrawer, "init_params", port)
    monkeypatch.setattr(JPixel, "init_params", ref)
    return seen


INITS = {
    "image_alpha": dict(init_image="{rgba}", init_image_alpha=90, init_noise="pixels"),
    "two_images_white": dict(init_image="{dir}/*.png", init_noise=None),
    "gradient": dict(init_noise="gradient"),
    "other_noise_is_white": dict(init_noise="clouds"),
    "snow_off_grid": dict(init_noise="snow", size=[50, 33], pixel_size=[25, 11]),
}


@pytest.mark.parametrize("name", list(INITS))
def test_init_tensor_matches_jax(tmp_path, pngs, monkeypatch, name):
    extra = {k: v.format(dir=tmp_path, **pngs) if isinstance(v, str) else v for k, v in INITS[name].items()}
    cfg = dict(dict(drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[48, 32], num_cuts=8,
                    vector_prompts="none", seed=5, precision="fp32", outdir=str(tmp_path)), **extra)
    seen = _record_init_tensor(monkeypatch)
    ref = JEngine(j_apply_settings(dict(cfg), apply_side_effects=False))
    port = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cpu")
    np.testing.assert_array_equal(seen["port"].numpy(), seen["jax"])
    if ref.init_image_tensor is None:
        assert port.init_image_tensor is None
    else:
        np.testing.assert_array_equal(port.init_image_tensor.numpy(), np.asarray(ref.init_image_tensor))
    # the pixel drawer's box means from an f32 integral image round apart (tests/test_torch_pixel.py)
    np.testing.assert_allclose(port.z.numpy(), np.asarray(ref.z), atol=2e-3)
