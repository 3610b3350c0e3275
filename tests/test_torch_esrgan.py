"""Real-ESRGAN and the super_resolution drawer of the port against the JAX
package on the CPU.

- a tiny RRDBNet (16 features, 1 block, growth 8) against the flax one
  through ``state_dict_from_flax_rrdbnet``, with its input gradient,
  within 1e-4; the full-width module's names and shapes equal the JAX
  converter's tree (built on the meta device);
- ``enhance_tiled``: one tile covering the image is the whole-image
  result; overlapping tiles the JAX function's tiles (1e-4);
- a basicsr checkpoint (``params_ema``) written to
  ``<tmp>/super_resolution_<model>.ckpt`` loads through
  ``$PIXRAY_TPU_MODELS``, the widths read from it;
- ``params_from_image`` against ``jax.image.resize``'s antialiased
  bilinear (1e-6), ``init_params`` given the JAX uniform draw;
- the super_resolution slice: the port's Engine against the JAX Engine
  with the same tiny RRDBNet and TinyTest, the JAX engine's draws
  replayed, per-step losses (1e-4) and latent (1e-3 but at 0.1% of its
  elements at most, held to 2·lr per step: Adam's step can go either way
  on a ~1e-7 gradient); and in the port a blocked run (``--steps_per_call
  2``) bitwise a single-step run from one seed and latent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixray_tpu.drawers.super_resolution as jsr
from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.drawers.super_resolution import SuperResolutionDrawer as JDrawer
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.models import esrgan as JE
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.drawers.super_resolution import SuperResolutionDrawer
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models import esrgan as PE
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

TINY = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=4)


def _tiny_flax(seed=0):
    model = JE.RRDBNet(**TINY)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)))
    # non-zero biases, so their layout is tested too
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda v: rng.normal(0.0, 0.1, v.shape).astype(np.float32) if v.ndim == 1
                                    else np.asarray(v), variables["params"])
    return model, {"params": params}


def _port(variables):
    sd = PE.state_dict_from_flax_rrdbnet(variables["params"])
    model = PE.rrdbnet_for(sd)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model.eval().requires_grad_(False)


def test_tiny_rrdbnet_and_its_input_gradient_match_jax():
    model, variables = _tiny_flax()
    port = _port(variables)
    assert (len(port.body), port.conv_first.out_channels, port.body[0].rdb1.conv1.out_channels) == (1, 16, 8)
    x = np.random.default_rng(1).random((1, 10, 14, 3)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((1, 40, 56, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: model.apply(variables, v), jnp.asarray(x))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = port(xt)
    (got * torch.tensor(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-4, rtol=0)


def test_full_width_names_match_the_jax_converter():
    with torch.device("meta"):
        port = PE.RRDBNet()
    sd = {k: np.zeros(v.shape, np.float32) for k, v in port.state_dict().items()}
    converted = JE.convert_rrdbnet(sd)
    back = PE.state_dict_from_flax_rrdbnet(converted["params"])
    assert {k: v.shape for k, v in back.items()} == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert len(port.body) == 23


def test_enhance_tiled_matches_jax():
    model, variables = _tiny_flax(3)
    port = _port(variables)
    img = np.random.default_rng(0).random((1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        whole = PE.enhance_tiled(port, torch.tensor(img))
        full_tile = PE.enhance_tiled(port, torch.tensor(img), tile=16, tile_pad=4)
        tiled = PE.enhance_tiled(port, torch.tensor(img), tile=8, tile_pad=6)
    np.testing.assert_array_equal(full_tile.numpy(), whole.numpy())
    want = np.asarray(JE.enhance_tiled(model, variables, jnp.asarray(img), tile=8, tile_pad=6))
    np.testing.assert_allclose(tiled.numpy(), want, atol=1e-4, rtol=0)
    assert tiled.shape == whole.shape == (1, 64, 64, 3)


def test_checkpoint_found_on_disk(tmp_path, monkeypatch):
    _, variables = _tiny_flax(4)
    sd = PE.state_dict_from_flax_rrdbnet(variables["params"])
    torch.save({"params_ema": {k: torch.tensor(v) for k, v in sd.items()}},
               tmp_path / "super_resolution_RealESRGAN_x4plus.ckpt")
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    settings = apply_settings(dict(drawer="super_resolution", prompts="x", size=[32, 32]), apply_side_effects=False)
    drawer = SuperResolutionDrawer(settings)
    drawer.load_model(settings, "cpu")
    assert len(drawer.model.body) == 1
    for k, v in drawer.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_init_params_and_params_from_image_match_jax():
    settings = apply_settings(dict(drawer="super_resolution", prompts="x", size=[48, 32]), apply_side_effects=False)
    ref, port = JDrawer(settings), SuperResolutionDrawer(settings)
    img = np.random.default_rng(0).uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    want = np.asarray(ref.params_from_image(jnp.asarray(img)))
    got = port.params_from_image(torch.tensor(img)).numpy()
    assert got.shape == want.shape == (8, 12, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the uniform draw passed in, and an init image through the resize
    key = jax.random.PRNGKey(2)
    draw = np.asarray(ref.init_params(key))
    np.testing.assert_array_equal(port.init_params(None, rgb=draw).numpy(), draw)
    np.testing.assert_array_equal(port.init_params(None, torch.tensor(img)).numpy(), got)


SLICE = dict(
    drawer="super_resolution", prompts="sunrise", clip_models="TinyTest", size=[48, 32], num_cuts=8, batches=1,
    iterations=3, save_every=100000, display_every=100000, init_noise=None, vector_prompts="none", seed=1,
    save_intermediates=False, learning_rate_drops=[], precision="fp32", steps_per_call=1,
)


def test_super_resolution_slice_matches_jax_engine(tmp_path, monkeypatch):
    model, variables = _tiny_flax(5)
    monkeypatch.setitem(jsr._global_model_cache, "models/super_resolution_RealESRGAN_x4plus.ckpt",
                        {"model": model, "variables": variables})
    for d in ("jax", "port", "blocked"):
        (tmp_path / d).mkdir()
    ref = JEngine(j_apply_settings(dict(SLICE, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    state_dicts = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    state_dicts["super_resolution"] = PE.state_dict_from_flax_rrdbnet(variables["params"])
    port = Engine(apply_settings(dict(SLICE, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=state_dicts)
    assert port.z.shape == ref.z.shape == (8, 12, 3)
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    lr = port.args.learning_rate
    for it in range(SLICE["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32], SLICE["num_cuts"], 48 / 32, SLICE["batches"])
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        diff = np.abs(port.z.numpy() - np.asarray(ref.z))
        assert (diff > 1e-3).mean() <= 1e-3 and diff.max() <= 2 * lr * (it + 1), (it, diff.max())
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0"]

    # blocked (steps 1-2 one block) and single steps from one seed and state: bitwise
    single, blocked = (Engine(apply_settings(dict(SLICE, outdir=str(tmp_path / d), steps_per_call=spc),
                                             apply_side_effects=False), device="cpu", state_dicts=state_dicts)
                       for d, spc in (("port", 1), ("blocked", 2)))
    for e in (single, blocked):
        e.z.copy_(torch.tensor(np.asarray(ref.z)))
        for it in range(SLICE["iterations"]):
            e.train(it)
    assert blocked.dispatched_blocks == [(1, 2)] and not single.dispatched_blocks
    assert torch.equal(single.z, blocked.z)
