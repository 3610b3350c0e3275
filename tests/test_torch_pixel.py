"""Port pixel drawer against the JAX one: grid sizing, coverage map and
separable operators (equal), synth and clip_params (float32, 1e-6: the same
small matmuls), params_from_image (see its tolerance), the SVG export
(the JAX drawer's text)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.drawers.pixel import PixelDrawer as JPixel
from pixray_tpu.ops import cellrender as JCR
from pixray_tpu_torch.drawers.pixel import PixelDrawer
from pixray_tpu_torch.ops import cellrender as CR


def _settings(size, pixel_size=None, pixel_scale=None, transparent=False):
    return SimpleNamespace(size=list(size), pixel_size=pixel_size, pixel_scale=pixel_scale,
                           pixel_type="rect", pixel_edge_check=True, pixel_iso_check=True,
                           transparent=transparent)


@pytest.mark.parametrize("size,pixel_size,pixel_scale", [
    ((96, 54), None, None), ((40, 40), None, None), ((30, 50), None, 2.0), ((64, 48), [10, 7], None),
])
def test_grid_sizing_and_coverage(size, pixel_size, pixel_scale):
    s = _settings(size, pixel_size, pixel_scale)
    port, ref = PixelDrawer(s), JPixel(s)
    port.snap_canvas(size)
    ref.snap_canvas(size)
    assert (port.num_cols, port.num_rows, port.num_cells) == (ref.num_cols, ref.num_rows, ref.num_cells)
    polys = [np.asarray(p) for p in ref.polygons]
    for a, b in zip(CR.build_coverage_map(polys, *size), JCR.build_coverage_map(polys, *size)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.model_params["sep_row_op"].numpy(), np.asarray(ref.model_params["sep_row_op"]))
    np.testing.assert_array_equal(port.model_params["sep_col_op"].numpy(), np.asarray(ref.model_params["sep_col_op"]))


@pytest.mark.parametrize("transparent", [False, True])
def test_synth_and_clip_params(transparent):
    size = (96, 54)
    s = _settings(size, transparent=transparent)
    port, ref = PixelDrawer(s), JPixel(s)
    port.snap_canvas(size)
    ref.snap_canvas(size)
    rng = np.random.default_rng(0)
    z = rng.uniform(-0.2, 1.2, (port.num_cells, 4)).astype(np.float32)
    cot = rng.standard_normal((54, 96, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: ref.synth(ref.model_params, v, 0), jnp.asarray(z))
    (ref_g,) = vjp(jnp.asarray(cot))
    zt = torch.tensor(z, requires_grad=True)
    mine = port.synth(port.model_params, zt)
    (g,) = torch.autograd.grad(mine, zt, torch.tensor(cot))
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5)
    np.testing.assert_array_equal(port.clip_params(torch.tensor(z)).numpy(),
                                  np.asarray(ref.clip_params(jnp.asarray(z))))


def test_init_params_and_params_from_image():
    size = (96, 54)
    s = _settings(size)
    port, ref = PixelDrawer(s), JPixel(s)
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (54, 96, 3)).astype(np.float32)
    # box means from an f32 integral image: four terms near 2.6e3 (ulp 2.4e-4)
    # cancel, then divide by 1-4 px cell areas; the two cumsums round apart
    np.testing.assert_allclose(port.params_from_image(torch.tensor(img)).numpy(),
                               np.asarray(ref.params_from_image(jnp.asarray(img))), atol=2e-3)
    key = jax.random.PRNGKey(3)
    j_z = np.asarray(ref.init_params(key))
    rgb = jax.random.uniform(key, (ref.num_cells, 3))
    np.testing.assert_array_equal(port.init_params(None, rgb=np.array(rgb)).numpy(), j_z)


def test_non_rect_geometry_is_refused():
    s = _settings((96, 54))
    s.pixel_type = "hex"
    with pytest.raises(NotImplementedError):
        PixelDrawer(s)


@pytest.mark.parametrize("w,h", [(96, 54), (300, 200)])
def test_init_noise_matches_jax(w, h):
    """``--init_noise pixels`` (the CLI default): same numpy draws, same image."""
    from pixray_tpu.utils.noise import random_noise_image
    from pixray_tpu_torch.utils.noise import random_noise_array

    ref = np.asarray(random_noise_image(w, h, np.random.default_rng(5)))
    np.testing.assert_array_equal(random_noise_array(w, h, np.random.default_rng(5)), ref)


@pytest.mark.parametrize("size", [(96, 54), (50, 30)])
def test_to_svg_matches_jax(size):
    """One polygon per cell, the colours clipped and truncated to 0-255 and
    the alpha to 3 decimals: the JAX drawer's text exactly (latent values
    outside [0, 1] included)."""
    s = _settings(size, transparent=True)
    port, ref = PixelDrawer(s), JPixel(s)
    port.snap_canvas(size)
    ref.snap_canvas(size)
    z = np.random.default_rng(7).uniform(-0.2, 1.2, (port.num_cells, 4)).astype(np.float32)
    text = port.to_svg(torch.tensor(z))
    assert text == ref.to_svg(jnp.asarray(z))
    assert text.count("<polygon") == port.num_cells
