"""The port's stroke drawers (clipdraw, line_sketch), their per-group Adam
and the clipdraw slice end to end, against the JAX package on the CPU.

The JAX drawers seed their numpy generator from ``jax.random.randint``,
which torch cannot reproduce, so every comparison carries the JAX latent
across with ``drawers.clipdraw.latent_from_numpy``.

Tolerances: synth 1e-4 (the stroke forward's); clip_params and the SVG
exact; Adam 1e-6 (as tests/test_torch_engine.py).  The slice (TinyTest,
96x54, 16 strokes, 8 cuts, 3 steps, float32, the JAX draws replayed):
per-step loss 1e-4; first-step gradients per group rtol 2e-4, atol 2e-5
after dividing by max|JAX gradient| (the stroke tests' tolerance); latents
after 3 steps within 1e-2 px (points) and 1e-3 (widths, colors) — Adam
divides each gradient by its own running norm, so an element whose
gradient is tiny moves by up to lr·Δg/|g|.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.drawers.clipdraw import ClipDrawer as JClipDrawer
from pixray_tpu.drawers.line_sketch import LineDrawer as JLineDrawer
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.engine.step import build_loss_fn as j_build_loss_fn
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.drawers.clipdraw import ClipDrawer, latent_from_numpy, numpy_latent
from pixray_tpu_torch.drawers.line_sketch import LineDrawer
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.latent import ravel, tree_map
from pixray_tpu_torch.engine.step import loss_and_grads
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

DRAWERS = {
    "clipdraw": (JClipDrawer, ClipDrawer,
                 dict(size=[96, 54], strokes=16, min_stroke_width=1, max_stroke_width=5)),
    "line_sketch": (JLineDrawer, LineDrawer,
                    dict(size=[96, 54], strokes=6, stroke_length=8, min_stroke_width=0.5,
                         max_stroke_width=2, allow_paper_color=False)),
    "line_sketch_paper": (JLineDrawer, LineDrawer,
                          dict(size=[96, 54], strokes=6, stroke_length=8, min_stroke_width=0.5,
                               max_stroke_width=2, allow_paper_color=True)),
}


def _drawers(name):
    """(JAX drawer, port drawer, JAX latent as numpy, port latent, port model_params)."""
    jcls, pcls, settings = DRAWERS[name]
    settings = SimpleNamespace(**settings)
    jd, pd = jcls(settings), pcls(settings)
    jz = {k: np.asarray(v) for k, v in jd.init_params(jax.random.PRNGKey(4)).items()}
    z, params = latent_from_numpy(jz, jd.model_params)
    return jd, pd, jz, z, params


@pytest.mark.parametrize("name", list(DRAWERS))
def test_drawer_init_matches_jax_for_one_numpy_seed(name):
    """Given one numpy generator, both inits draw the same strokes; the
    port's init_params gives a latent of the JAX one's keys, shapes and dtypes."""
    jd, pd, jz, _, _ = _drawers(name)
    draw = lambda d: d._init_strokes(np.random.default_rng(7))  # clipdraw: (counts, points)
    ref, out = draw(jd), draw(pd)
    for a, b in zip(ref if isinstance(ref, tuple) else (ref,), out if isinstance(out, tuple) else (out,)):
        np.testing.assert_array_equal(a, b)
    z = numpy_latent(pd.init_params(torch.Generator().manual_seed(0)))
    assert {k: (v.shape, v.dtype) for k, v in z.items()} == {k: (v.shape, v.dtype) for k, v in jz.items()}
    assert pd.model_params["basis"].shape == jd.model_params["basis"].shape


@pytest.mark.parametrize("name", list(DRAWERS))
def test_drawer_synth_matches_jax(name):
    jd, pd, jz, z, params = _drawers(name)
    ref = np.asarray(jd.synth(jd.model_params, {k: jnp.asarray(v) for k, v in jz.items()}, 0))
    out = pd.synth(params, z)
    assert out.shape == ref.shape == (54, 96, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("name", list(DRAWERS))
def test_drawer_clip_params_and_svg_match_jax(name):
    jd, pd, jz, _, _ = _drawers(name)
    rng = np.random.default_rng(1)
    # push every group outside its range so the clamps act
    jz = {k: (v * rng.uniform(-1.5, 2.5, v.shape)).astype(np.float32) for k, v in jz.items()}
    ref = {k: np.asarray(v) for k, v in jd.clip_params({k: jnp.asarray(v) for k, v in jz.items()}).items()}
    out = numpy_latent(pd.clip_params(latent_from_numpy(jz, {})[0]))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    assert pd.to_svg(latent_from_numpy(ref, {})[0]) == jd.to_svg({k: jnp.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("name", ["clipdraw", "line_sketch_paper"])
def test_per_group_adam_matches_optax(name):
    """Three updates; before the third an LR drop (fresh state, updates
    scaled by 0.1), as both engines drop the learning rate."""
    jd, pd, jz, z, _ = _drawers(name)
    args = SimpleNamespace()
    jopt, popt = jd.get_opts(args, 1.0), pd.get_opts(args, 1.0)
    jzz = {k: jnp.asarray(v) for k, v in jz.items()}
    jstate, pstate = jopt.init(jzz), popt.init(z)
    rng = np.random.default_rng(2)
    for i, scale in enumerate((1.0, 1.0, 0.1)):
        if i == 2:
            jstate, pstate = jopt.init(jzz), popt.init(z)
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
             for k, v in jz.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jzz)
        jzz = optax.apply_updates(jzz, jax.tree_util.tree_map(lambda u: u * scale, upd))
        pupd, pstate = popt.update(latent_from_numpy(g, {})[0], pstate)
        z = tree_map(lambda p, u: p + u * scale, z, pupd)
        for k in jz:
            np.testing.assert_allclose(z[k].numpy(), np.asarray(jzz[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("settings", [
    dict(drawer="clipdraw", prompts="sunrise", size=[384, 216], strokes=512, seed=1),
    dict(drawer="line_sketch", prompts="sunrise", quality="draft", stroke_length=4,
         allow_paper_color=True, iterations=40),
])
def test_stroke_settings_resolve_like_jax(settings):
    port = vars(apply_settings(dict(settings), apply_side_effects=False))
    ref = vars(j_apply_settings(dict(settings), apply_side_effects=False))
    assert port == ref


SLICE = dict(
    drawer="clipdraw", strokes=16, prompts="sunrise", clip_models="TinyTest", size=[96, 54],
    num_cuts=8, batches=1, iterations=3, save_every=100000, display_every=100000,
    init_noise=None, vector_prompts="none", seed=1, save_intermediates=False,
    learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
)


def _scaled_close(port, ref, name):
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(port / scale, ref / scale, rtol=2e-4, atol=2e-5, err_msg=name)


def test_clipdraw_slice_matches_jax_engine(tmp_path, monkeypatch):
    # the branch jax.lax.platform_dependent takes on the CPU anyway (XLA
    # strokes and warp), without tracing the TPU kernels' branch (~40 s)
    monkeypatch.setenv("PIXRAY_TPU_PALLAS", "0")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(SLICE, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    jp = ref.perceptors[0]
    weights = {"TinyTest": state_dict_from_flax(jp.variables["params"], jp.config)}
    port = Engine(apply_settings(dict(SLICE, outdir=str(tmp_path / "port"), save_svg=True),
                                 apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    port.z, params = latent_from_numpy({k: np.asarray(v) for k, v in ref.z.items()}, ref.drawer.model_params)
    port.drawer_params.update(params)  # the step config holds this dict
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = ravel(port.z)
    # ravel_pytree order: dict keys sorted (colors, points, widths)
    np.testing.assert_array_equal(port.step_cfg.z_orig_flat.numpy(), np.asarray(ref.z_orig_flat))

    j_loss = j_build_loss_fn(ref.step_cfg)
    j_grad = jax.jit(jax.grad(lambda z, key: j_loss(z, ref.refs, key, 0, 0)[0]))
    for it in range(SLICE["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32], SLICE["num_cuts"], 96 / 54, 1)
        if it == 0:
            grads = j_grad(ref.z, jax.random.split(k_step, 1)[0])
            pgrads, _ = loss_and_grads(port.step_cfg, port.z, 0, draws)
            for k in ("points", "widths", "colors"):
                _scaled_close(pgrads[k].numpy(), np.asarray(grads[k]), f"first-step gradient: {k}")
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
    for k, atol in (("points", 1e-2), ("widths", 1e-3), ("colors", 1e-3)):
        np.testing.assert_allclose(port.z[k].numpy(), np.asarray(ref.z[k]), atol=atol, err_msg=k)
    assert port.loss_names == ref.loss_names
    port.cur_iteration = SLICE["iterations"]
    port.run()  # the final checkin, then --save_svg
    assert (tmp_path / "port" / "output.png").exists()
    svg = (tmp_path / "port" / "output.svg").read_text()
    assert svg == port.drawer.to_svg(port.z) and svg.count("<path ") == SLICE["strokes"]
