"""The fft drawer (fft, dwt and pixel modes), its wavelet matrices and the
fast_pixel drawer against the JAX package on the CPU.

- ``ops/wavelets.py`` is a copy: every supported filter and analysis
  matrix equal to the original's (bitwise: the same numpy code).
- ``synth`` on the JAX latent within 1e-6 (float32; irfftn / matmul sums
  in other orders), its gradient on every leaf and every bin within 1e-6 of
  max|g| (the DC column and, for even widths, the Nyquist column included:
  the imaginary parts there get what JAX's ``irfftn`` transpose gives
  them), for an even and an odd canvas width.
- ``params_from_image`` within 1e-5 of max|latent| (a float32 rfftn /
  wavelet analysis of logits up to ~7).
- fast_pixel: ``nearest_resize`` bitwise (a 0/1 matmul), its gradient
  within 1e-6; ``params_from_image`` (``jax.image.resize`` bilinear, which
  antialiases when it downsamples) within 1e-6, upsampling and
  downsampling; the grid heuristic equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.drawers.fast_pixel import FastPixelDrawer as JFastPixel
from pixray_tpu.drawers.fast_pixel import _grid_for_canvas
from pixray_tpu.drawers.fft import FftDrawer as JFft
from pixray_tpu.ops import wavelets as JW
from pixray_tpu.ops.pool import nearest_resize as j_nearest_resize
from pixray_tpu_torch.drawers.fast_pixel import FastPixelDrawer, grid_for_canvas
from pixray_tpu_torch.drawers.fft import FftDrawer
from pixray_tpu_torch.ops import wavelets as PW
from pixray_tpu_torch.ops.pool import linear_resize, nearest_resize


def _settings(use, size, wave="coif2"):
    return SimpleNamespace(size=list(size), fft_use=use, fft_decay=1.5, fft_wave=wave, fft_sharp=0.3,
                           fft_colors=1.5, fft_lrate=0.3)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("name", ["haar", "db1", "db4", "db20", "coif1", "coif2", "coif5"])
def test_wavelet_copy_equals_original(name):
    np.testing.assert_array_equal(PW.wavelet_filter(name), JW.wavelet_filter(name))
    for n in (8, 46):
        np.testing.assert_array_equal(PW.analysis_matrix(n, PW.wavelet_filter(name)),
                                      JW.analysis_matrix(n, JW.wavelet_filter(name)))
    with pytest.raises(ValueError):
        PW.wavelet_filter("sym4")


@pytest.mark.parametrize("use,size,wave", [
    ("fft", (20, 12), "coif2"), ("fft", (21, 13), "coif2"),
    ("dwt", (40, 24), "coif2"), ("dwt", (36, 20), "haar"),
    ("pixel", (20, 12), "coif2"),
])
def test_fft_drawer_matches_jax(use, size, wave):
    s = _settings(use, size, wave)
    ref, port = JFft(s), FftDrawer(s)
    ref.snap_canvas(size)
    port.snap_canvas(size)
    z = ref.init_params(jax.random.PRNGKey(3))
    zt = _t(z)
    if isinstance(z, dict):
        assert sorted(zt) == sorted(z)
    img = np.asarray(ref.synth({}, z, 0))
    got = port.synth(port.model_params, zt)
    assert got.shape == img.shape == (size[1], size[0], 3)
    np.testing.assert_allclose(got.numpy(), img, atol=1e-6)

    # the gradient on every bin / coefficient
    g = np.random.default_rng(0).standard_normal(img.shape).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(ref.synth({}, z, 0) * g))(z)
    leaves = [leaf.requires_grad_(True) for leaf in (zt.values() if isinstance(zt, dict) else [zt])]
    (port.synth(port.model_params, zt) * torch.tensor(g)).sum().backward()
    want_leaves = [want[k] for k in zt] if isinstance(zt, dict) else [want]
    for w, leaf in zip(want_leaves, leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-6 * np.abs(w).max())
    if use == "fft":  # the columns whose imaginary parts irfft ignores
        w = np.asarray(want)
        edge = [0] + ([w.shape[2] - 1] if size[0] % 2 == 0 else [])
        np.testing.assert_allclose(zt.grad.numpy()[:, :, edge, 1], w[:, :, edge, 1],
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("use,size", [("fft", (20, 12)), ("fft", (21, 13)), ("dwt", (40, 24)),
                                      ("dwt", (37, 22)), ("pixel", (20, 12))])
def test_fft_params_from_image_matches_jax(use, size):
    s = _settings(use, size)
    ref, port = JFft(s), FftDrawer(s)
    ref.snap_canvas(size)
    port.snap_canvas(size)
    image = np.random.default_rng(1).uniform(-1, 1, (size[1], size[0], 3)).astype(np.float32)
    want = ref.params_from_image(jnp.asarray(image))
    got = port.params_from_image(torch.tensor(image))
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())
    # the engine's init path: the same latent from init_params
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(port.init_params(torch.Generator(), torch.tensor(image)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * np.abs(np.asarray(w)).max())


def test_fft_drawer_latent_shapes():
    for use, want in (("fft", [(3, 12, 11, 2)]), ("pixel", [(3, 12, 20)]),
                      ("dwt", [(3, 3, 1, 2), (3, 3, 2, 4), (3, 3, 4, 8), (3, 3, 8, 16), (3, 1, 2)])):
        d = FftDrawer(_settings(use, (20, 12)))
        d.snap_canvas((20, 12))
        z = d.init_params(torch.Generator().manual_seed(0))
        shapes = [tuple(v.shape) for _, v in sorted(z.items())] if isinstance(z, dict) else [tuple(z.shape)]
        assert shapes == want
    with pytest.raises(ValueError):
        FftDrawer(_settings("dwt", (20, 12), wave="sym4"))


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (30, 50)), ((45, 80), (216, 384)), ((6, 6), (6, 13))])
def test_nearest_resize_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(2).random(in_hw + (3,)).astype(np.float32)
    want = np.asarray(j_nearest_resize(jnp.asarray(x), *out_hw))
    xt = torch.tensor(x, requires_grad=True)
    got = nearest_resize(xt, *out_hw)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    (got * torch.tensor(g)).sum().backward()
    gw = np.asarray(jax.grad(lambda a: jnp.sum(j_nearest_resize(a, *out_hw) * g))(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), gw, atol=1e-6 * np.abs(gw).max())


@pytest.mark.parametrize("in_hw,out_hw", [((30, 50), (5, 7)), ((216, 384), (45, 80)), ((7, 9), (20, 31)),
                                          ((13, 13), (13, 5))])
def test_linear_resize_matches_jax_image_resize(in_hw, out_hw):
    x = np.random.default_rng(4).random(in_hw + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out_hw + (3,), method="bilinear"))
    np.testing.assert_allclose(linear_resize(torch.tensor(x), *out_hw).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("size,pixel_size,pixel_scale", [
    ((384, 216), None, None), ((144, 144), None, None), ((100, 160), None, 2.0), ((50, 30), [7, 5], None),
    ((20, 10), None, None),
])
def test_fast_pixel_matches_jax(size, pixel_size, pixel_scale):
    s = SimpleNamespace(size=list(size), pixel_size=pixel_size, pixel_scale=pixel_scale)
    assert grid_for_canvas(s) == _grid_for_canvas(s)
    ref, port = JFastPixel(s), FastPixelDrawer(s)
    ref.snap_canvas(size)
    assert port.snap_canvas(size) == tuple(size)
    image = np.random.default_rng(5).uniform(-1, 1, (size[1], size[0], 3)).astype(np.float32)
    want = np.asarray(ref.params_from_image(jnp.asarray(image)))
    np.testing.assert_allclose(port.params_from_image(torch.tensor(image)).numpy(), want, atol=1e-6)
    z = np.random.default_rng(6).uniform(-0.2, 1.2, want.shape).astype(np.float32)
    np.testing.assert_array_equal(port.synth({}, torch.tensor(z)).numpy(), np.asarray(ref.synth({}, jnp.asarray(z), 0)))
    np.testing.assert_array_equal(port.clip_params(torch.tensor(z)).numpy(), np.asarray(ref.clip_params(jnp.asarray(z))))
    assert tuple(port.init_params(torch.Generator().manual_seed(0)).shape) == want.shape
