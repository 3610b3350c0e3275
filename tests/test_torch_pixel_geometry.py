"""The pixel drawer's non-rect geometries in the port against the JAX
package: rectshift, hex, tri, diamond and knit.

- Grid sizing (the iso and edge checks on and off), the polygons, the
  coverage map and its inverse map at 48x36 and at an odd 45x31 canvas:
  equal to the JAX drawer's as built (the JAX package rasterizes with its
  C++ library where it is present, the port with numpy; the maps must
  agree index for index, subsample centres on a seam included).
- ``composite_cells``: forward within 1e-6, the colour gradient within
  1e-5, through the drawer's ``synth``.
- The colour gradient is a gather over the inverse map: the backward
  dispatches no ``index_add`` and no scatter.
- ``init_params`` equal; ``params_from_image`` within the rect grid's
  tolerance (tests/test_torch_pixel.py); ``to_svg`` the JAX drawer's text.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pixray_tpu.drawers.pixel import PixelDrawer as JPixel
from pixray_tpu_torch.drawers.pixel import PixelDrawer
from pixray_tpu_torch.ops import cellrender as CR

TYPES = ["rectshift", "hex", "tri", "diamond", "knit"]
SIZES = [(48, 36), (45, 31)]
GRID = [13, 9]  # cells of a few pixels: every geometry is non-separable


def _settings(size, pixel_type, checks=True, transparent=True, pixel_size=None):
    return SimpleNamespace(size=list(size), pixel_size=pixel_size, pixel_scale=None, pixel_type=pixel_type,
                           pixel_edge_check=checks, pixel_iso_check=checks, transparent=transparent)


def _pair(size, pixel_type, **kw):
    s = _settings(size, pixel_type, **kw)
    port, ref = PixelDrawer(s), JPixel(s)
    port.snap_canvas(size)
    ref.snap_canvas(size)
    return port, ref


@pytest.mark.parametrize("checks", [True, False], ids=["checks", "no-checks"])
@pytest.mark.parametrize("size", SIZES, ids=["48x36", "45x31"])
@pytest.mark.parametrize("pixel_type", TYPES)
def test_grid_maps_equal_jax(pixel_type, size, checks):
    # a grid that fits the small canvas; the iso check scales only the default grids
    port, ref = _pair(size, pixel_type, checks=checks, pixel_size=None if checks else [13, 9])
    assert (port.num_cols, port.num_rows, port.num_cells) == (ref.num_cols, ref.num_rows, ref.num_cells)
    for a, b in zip(port.polygons, ref.polygons):
        np.testing.assert_array_equal(a, b)
    # knit's default grid shrunk to 1 px cells factorizes like the rect grid, in both
    assert sorted(port.model_params) == sorted(ref.model_params)
    for name in port.model_params:
        np.testing.assert_array_equal(port.model_params[name].numpy(), np.asarray(ref.model_params[name]), name)


def test_iso_and_edge_checks_reshape_the_bench_grid():
    """The bench's 384x216 canvas (default 80x45 grid) under each geometry, as the JAX drawer sizes it."""
    want = {"rectshift": (81, 45), "hex": (81, 63), "diamond": (81, 91), "tri": (113, 46), "knit": (80, 45)}
    for pixel_type, grid in want.items():
        s = _settings((384, 216), pixel_type)
        port, ref = PixelDrawer(s), JPixel(s)
        assert (port.num_cols, port.num_rows) == (ref.num_cols, ref.num_rows) == grid


@pytest.mark.parametrize("pixel_type", TYPES)
def test_composite_and_gradient_match_jax(pixel_type):
    port, ref = _pair((45, 31), pixel_type, pixel_size=GRID)
    assert "coverage_indices" in port.model_params
    rng = np.random.default_rng(TYPES.index(pixel_type))
    z = rng.uniform(-0.2, 1.2, (port.num_cells, 4)).astype(np.float32)
    cot = rng.standard_normal((31, 45, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: ref.synth(ref.model_params, v, 0), jnp.asarray(z))
    (ref_g,) = vjp(jnp.asarray(cot))
    zt = torch.tensor(z, requires_grad=True)
    mine = port.synth(port.model_params, zt)
    (g,) = torch.autograd.grad(mine, zt, torch.tensor(cot))
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_colour_gradient_is_a_gather():
    port, _ = _pair((45, 31), "knit", pixel_size=GRID)
    z = torch.rand((port.num_cells, 4), generator=torch.Generator().manual_seed(0), requires_grad=True)
    out = port.synth(port.model_params, z)
    with _OpLog() as log:
        (g,) = torch.autograd.grad(out.sum(), z)
    assert any("index_select" in op for op in log.ops), log.ops
    assert not [op for op in log.ops if "index_add" in op or "scatter" in op or "index_put" in op], log.ops
    # the gather sums each cell's slots: every covering subsample's weight
    slots = port.model_params["cell_slot_valid"].sum(1).float()
    expect = torch.where(slots > 0, g[:, 3], torch.zeros(()))
    assert torch.equal(g[:, 3] != 0, expect != 0)


@pytest.mark.parametrize("pixel_type", TYPES)
def test_init_params_image_and_svg_match_jax(pixel_type):
    port, ref = _pair((45, 31), pixel_type, pixel_size=GRID)
    key = jax.random.PRNGKey(3)
    rgb = jax.random.uniform(key, (ref.num_cells, 3))
    np.testing.assert_array_equal(port.init_params(None, rgb=np.array(rgb)).numpy(), np.asarray(ref.init_params(key)))
    img = np.random.default_rng(1).uniform(-1, 1, (31, 45, 3)).astype(np.float32)
    # as tests/test_torch_pixel.py: box means from two f32 integral images
    np.testing.assert_allclose(port.params_from_image(torch.tensor(img)).numpy(),
                               np.asarray(ref.params_from_image(jnp.asarray(img))), atol=2e-3)
    z = np.random.default_rng(7).uniform(-0.2, 1.2, (port.num_cells, 4)).astype(np.float32)
    text = port.to_svg(torch.tensor(z))
    assert text == ref.to_svg(jnp.asarray(z))
    assert text.count("<polygon") == port.num_cells


def test_inverse_map_lists_every_slot_once():
    port, _ = _pair((48, 36), "diamond", pixel_size=GRID)
    mp = port.model_params
    slots = mp["cell_slots"][mp["cell_slot_valid"]]
    flat_valid = mp["coverage_valid"].reshape(-1)
    assert torch.equal(torch.sort(slots).values, torch.nonzero(flat_valid)[:, 0])
    cells = mp["coverage_indices"].reshape(-1)[slots]
    owner = torch.arange(port.num_cells)[:, None].expand_as(mp["cell_slots"])[mp["cell_slot_valid"]]
    assert torch.equal(cells, owner)
    assert CR.try_separable_operators(mp["coverage_indices"].numpy(), mp["coverage_valid"].numpy(),
                                      port.num_rows, port.num_cols) is None


@pytest.mark.parametrize("pixel_type", TYPES)
def test_bench_canvas_maps_equal_jax(pixel_type):
    """The maps at the bench's 384x216 canvas, which the card's rows run."""
    port, ref = _pair((384, 216), pixel_type)
    for name in port.model_params:
        np.testing.assert_array_equal(port.model_params[name].numpy(), np.asarray(ref.model_params[name]), name)


@pytest.mark.parametrize("pixel_type", TYPES)
def test_each_geometry_runs_through_run(tmp_path, pixel_type):
    """``pixray_tpu_torch.run`` (the CLI's entry point) on the CPU, 2 steps
    at 48x36 under TinyTest: finite losses and the checkin PNG."""
    import pixray_tpu_torch

    outdir = tmp_path / pixel_type
    assert pixray_tpu_torch.run("sunrise", drawer="pixel", device="cpu", pixel_type=pixel_type,
                                clip_models="TinyTest", size=[48, 36], num_cuts=4, iterations=2, save_every=1,
                                init_noise=None, vector_prompts="none", outdir=str(outdir),
                                save_intermediates=False)
    engine = pixray_tpu_torch.get_engine()
    assert "coverage_indices" in engine.drawer_params or pixel_type == "knit"
    assert torch.isfinite(engine.last_loss_values).all()
    assert (outdir / "output.png").exists()
