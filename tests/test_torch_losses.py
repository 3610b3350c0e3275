"""The custom losses of the port against the JAX package's on the CPU:
saturation, symmetry, smoothness, palette, gaussian, edge and aesthetic.

Each case feeds both the same float32 cutouts (a dict of one or two cut
sizes, channels-last, as the step hands them over), canvas and settings,
and compares the value (summed when a loss returns one term per cut size)
within 1e-6 relative + 1e-7, and the gradients w.r.t. the cutouts, the
canvas and the embeddings within 1e-6 of the largest gradient entry
(float32 reductions in other orders).

- smoothness: the three types, the gaussian pre-blur (kernel 5, edge
  padding) and spacing 2; on flat cutouts the port's gradient is finite
  where JAX's is NaN (the square root at 0), and equal elsewhere;
- palette: pixels placed near the midpoints between palette colours (the
  nearest colour by the expanded form, first index on ties);
- edge: per-margin widths, a colour name, and a target image and a mask
  image that the test writes (PIL bicubic resize to the canvas);
- aesthetic: a head file the test writes (``ava_vit_b_16_linear.pth``
  under ``$PIXRAY_TPU_MODELS``), the zero head when there is none, and the
  inert result for embeddings that are not 512 wide.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.losses.aesthetic import AestheticLoss as JAesthetic
from pixray_tpu.losses.edge import EdgeLoss as JEdge
from pixray_tpu.losses.gaussian import GaussianLoss as JGaussian
from pixray_tpu.losses.palette import PaletteLoss as JPalette
from pixray_tpu.losses.saturation import SaturationLoss as JSaturation
from pixray_tpu.losses.smoothness import SmoothnessLoss as JSmoothness
from pixray_tpu.losses.symmetry import SymmetryLoss as JSymmetry
from pixray_tpu_torch.losses import add_custom_loss, loss_class
from pixray_tpu_torch.losses.base import LossInterface

PAIRS = {
    "saturation": JSaturation, "symmetry": JSymmetry, "smoothness": JSmoothness, "palette": JPalette,
    "gaussian": JGaussian, "edge": JEdge, "aesthetic": JAesthetic,
}
PALETTE = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.9, 0.1, 0.1], [0.2, 0.4, 0.8], [0.95, 0.9, 0.2]]


def _args(name, **overrides):
    parser = argparse.ArgumentParser()
    PAIRS[name].add_settings(parser)
    args = parser.parse_args([])
    args.palette = PALETTE
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def _cutouts(sizes, n=4, seed=0, near=None):
    rng = np.random.default_rng(seed)
    out = {}
    for s in sizes:
        x = rng.random((n, s, s, 3)).astype(np.float32)
        if near is not None:  # half the pixels near midpoints between palette colours
            table = np.asarray(near)
            flat = x.reshape(-1, 3)
            a, b = rng.integers(0, len(table), len(flat)), rng.integers(0, len(table), len(flat))
            mid = (0.5 * (table[a] + table[b]) + rng.normal(0, 1e-4, flat.shape)).astype(np.float32)
            flat[::2] = mid[::2]
        out[s] = x
    return out


def _compare(name, args, cutouts, canvas, embeds=None):
    ref, port = PAIRS[name](args), loss_class(name)(args)
    embeds = np.zeros((1, 1), np.float32) if embeds is None else embeds

    def jloss(cuts, out, emb):
        res = ref.get_loss(cuts, out, args, globals={"embeds": emb, "cur_iteration": 3, "fill_color": 0.5})
        return sum(res) if isinstance(res, (list, tuple)) else res

    jcuts = {k: jnp.asarray(v) for k, v in cutouts.items()}
    want, (gcuts, gout, gemb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jcuts, jnp.asarray(canvas), jnp.asarray(embeds))
    tcuts = {k: torch.tensor(v, requires_grad=True) for k, v in cutouts.items()}
    tout = torch.tensor(canvas, requires_grad=True)
    temb = torch.tensor(embeds, requires_grad=True)
    pglobals = {"embeds": temb, "cur_iteration": torch.tensor(3, dtype=torch.int32),
                "fill_color": torch.tensor(0.5)}
    res = port.get_loss(tcuts, tout, args, globals=pglobals, lossGlobals={})
    got = sum(res) if isinstance(res, (list, tuple)) else res
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-7)
    if got.requires_grad:
        got.backward()
    pairs = [(tout.grad, gout), (temb.grad, gemb)] + [(tcuts[k].grad, gcuts[k]) for k in cutouts]
    scale = max([float(np.abs(np.asarray(w)).max()) for _, w in pairs] + [1e-30])
    for g, w in pairs:
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6 * scale)
    return float(want)


CANVAS = np.random.default_rng(9).random((30, 44, 3)).astype(np.float32)


@pytest.mark.parametrize("sizes", [(32,), (32, 48)])
def test_saturation(sizes):
    _compare("saturation", _args("saturation", saturation_weight=2.0), _cutouts(sizes), CANVAS)


def test_symmetry():
    _compare("symmetry", _args("symmetry", symmetry_weight=0.7), _cutouts((32,)), CANVAS)


@pytest.mark.parametrize("kind", ["default", "clipped", "log"])
@pytest.mark.parametrize("kernel,spacing", [(0, 1), (5, 1), (0, 2)])
def test_smoothness(kind, kernel, spacing):
    args = _args("smoothness", smoothness_type=kind, smoothness_gaussian_kernel=kernel,
                 smoothness_gaussian_std=1.5, smoothness_spacing=spacing, smoothness_weight=0.5)
    _compare("smoothness", args, _cutouts((16, 24)), CANVAS)


@pytest.mark.parametrize("kind", ["default", "clipped"])
def test_smoothness_flat_cutouts_gradient(kind):
    """Flat stretches (every neighbour difference exactly 0, as bf16 cutouts
    with a small noise factor hold): the same value; JAX's gradient is NaN
    there (sqrt at 0), the port's is finite and equals JAX's wherever JAX's
    is finite."""
    args = _args("smoothness", smoothness_type=kind)
    cuts = _cutouts((16,))
    cuts[16][1:3, 4:12, :, :] = 0.25  # two cutouts' rows 4-11 flat
    ref, port = JSmoothness(args), loss_class("smoothness")(args)
    want, grad = jax.value_and_grad(lambda c: sum(ref.get_loss({16: c}, None, args)))(jnp.asarray(cuts[16]))
    x = torch.tensor(cuts[16], requires_grad=True)
    got = sum(port.get_loss({16: x}, None, args))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    grad = np.asarray(grad)
    assert np.isnan(grad).any() and torch.isfinite(x.grad).all()
    ok = np.isfinite(grad)
    np.testing.assert_allclose(x.grad.numpy()[ok], grad[ok], atol=1e-6 * np.abs(grad[ok]).max())


@pytest.mark.parametrize("sizes", [(32,), (16, 32)])
def test_palette_near_ties(sizes):
    _compare("palette", _args("palette", palette_weight=1.5), _cutouts(sizes, near=PALETTE), CANVAS)
    with pytest.raises(ValueError):
        loss_class("palette")(_args("palette", palette=None))


@pytest.mark.parametrize("std,color", [((40, 40), (255, 255, 255)), ((6.0, 11.0), (10, 200, 30))])
def test_gaussian(std, color):
    _compare("gaussian", _args("gaussian", gaussian_std=std, gaussian_color=color, gaussian_weight=2.0),
             _cutouts((32,)), CANVAS)


@pytest.fixture
def edge_images(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    target = tmp_path / "target.png"
    Image.fromarray(rng.integers(0, 256, (20, 27, 3), dtype=np.uint8)).save(target)
    mask = tmp_path / "mask.png"
    m = np.zeros((25, 25), np.uint8)
    m[5:18, 3:20] = 255
    Image.fromarray(m).save(mask)
    return str(target), str(mask)


@pytest.mark.parametrize("case", ["default", "margins", "color", "target", "mask", "target_mask", "no_global"])
def test_edge(case, edge_images):
    target, mask = edge_images
    extra = {
        "default": {},
        "margins": dict(edge_margins=[10, 0, 25, 7]),
        "color": dict(edge_color="sky blue", edge_thickness=12),
        "target": dict(edge_input_image=target),
        "mask": dict(edge_mask_image=mask),
        "target_mask": dict(edge_input_image=target, edge_mask_image=mask),
        "no_global": dict(global_color_weight=0.0, edge_margins=[0, 20, 0, 30]),
    }[case]
    _compare("edge", _args("edge", edge_color_weight=0.3, **extra), _cutouts((32,)), CANVAS)


@pytest.mark.parametrize("head", ["file", "zeros"])
def test_aesthetic(head, tmp_path, monkeypatch):
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    if head == "file":
        gen = torch.Generator().manual_seed(0)
        torch.save({"weight": torch.randn((1, 512), generator=gen) * 3, "bias": torch.tensor([4.5])},
                   tmp_path / "ava_vit_b_16_linear.pth")
    embeds = np.random.default_rng(5).standard_normal((6, 512)).astype(np.float32)
    value = _compare("aesthetic", _args("aesthetic", aesthetic_target=8.0), _cutouts((32,)), CANVAS, embeds=embeds)
    if head == "zeros":
        assert value == pytest.approx(0.02 * 64.0)
    narrow = np.ones((6, 32), np.float32)  # not the head's width: inert
    assert _compare("aesthetic", _args("aesthetic"), _cutouts((32,)), CANVAS, embeds=narrow) == 0.0


def test_loss_registry():
    from pixray_tpu.registry import _LOSS_MODULES as JAX_LOSSES

    for name, (_module, class_name) in JAX_LOSSES.items():  # every loss of the JAX package
        assert loss_class(name).__name__ == class_name
    with pytest.raises(KeyError):
        loss_class("nope")

    class Constant(LossInterface):
        def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
            return out.sum() * 0

    add_custom_loss("constant_test_loss", Constant)
    assert loss_class("constant_test_loss") is Constant
