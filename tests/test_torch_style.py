"""The STROTSS style loss and its VGG16 in the port against the JAX package.

- VGG16 features (the JAX params carried across by the bridge) within 1e-4
  relative, at an odd and an even size.
- The resize (``jax.image.resize(..., "bilinear")``, antialiased when it
  shrinks) at the loss's own size pairs, the Laplacian pyramid and its
  fold, and the hypercolumn gather at odd and even sizes: 1e-6 (values of
  order 1; the fold 1e-5).  Far upscales by odd ratios part by more (1.4e-5
  at 54x96 → 107x99): JAX places the samples with a float32 scale factor.
- The whole loss and its gradient against the JAX package's, at two
  scales: tests/test_torch_style_jax.py (a file of its own: the JAX
  loss's compile alone takes ~50 s).
- The port's gate: 0 with a finite zero gradient where it is off, the
  loss where it is on; the engine's host-side test agrees over several
  iterations.
- Blocked (``steps_per_call`` 8) against single steps with
  ``styleloss_every`` 2: per-step losses, the latent and the optimizer
  state bitwise equal on the CPU (a block takes the loss with its
  device-side gate; a single step leaves it out where the gate is off).
- Draw order: the style's draws come after every other draw of the step;
  a run with a loss that does not draw draws the stream of a run without.
- The standalone ``run_strotss`` runs and moves the image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.losses import style as JS
from pixray_tpu.models import vgg as JV
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.optimizers import state_tensors
from pixray_tpu_torch.losses import style as PS
from pixray_tpu_torch.models.vgg import load_vgg16, state_dict_from_flax_vgg16


@pytest.fixture(scope="module")
def vggs():
    params = JV.init_vgg16_params(jax.random.PRNGKey(16))
    return params, load_vgg16("cpu", state_dict=state_dict_from_flax_vgg16(params))


def _nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_strotss_draws(key, h, w):
    """The JAX loss's draws on an (h, w) canvas, named as the port's (``strotss_layout``)."""
    out = {}
    for si, scale in enumerate(PS.strotss_scales(h, w)):
        k_scale = jax.random.fold_in(key, si)
        uniforms = []
        for r in range(PS.ROUNDS):
            kx, ky = jax.random.split(jax.random.fold_in(k_scale, r))
            uniforms.append([jax.random.uniform(kx, (PS.SAMPLES,)), jax.random.uniform(ky, (PS.SAMPLES,))])
        _sx, _sy, nx, ny = PS.strided_grid(h // scale, w // scale)
        perms = [[jax.random.permutation(jax.random.fold_in(k_scale, it), nx * ny),
                  jax.random.permutation(jax.random.fold_in(k_scale, it + 50), nx * ny)] for it in (1, 2)]
        out[f"{si}/uniforms"] = torch.tensor(np.asarray(uniforms))  # float64 under jax.enable_x64
        out[f"{si}/offsets"] = torch.tensor(
            np.asarray(jax.random.randint(jax.random.fold_in(k_scale, 99), (2,), 0, 2**30), np.int32))
        out[f"{si}/perms"] = torch.tensor(np.asarray(perms, np.int32))
    return out


@pytest.mark.parametrize("hw", [(37, 41), (48, 64)], ids=["odd", "even"])
def test_vgg16_features_match_jax(vggs, hw):
    params, vgg = vggs
    x = np.random.default_rng(0).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    ref = JV.vgg16_features(params, jnp.asarray(x))
    got = vgg(_nchw(x))
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(_nhwc(g), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("hw", [(33, 35), (54, 96), (37, 48)], ids=["odd", "even", "mixed"])
def test_resize_pyramid_and_gather_match_jax(hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    xt = _nchw(x)
    # the loss's resizes: halving (odd sizes floor), back up to the full size, and the identity
    half = (hw[0] // 2, hw[1] // 2)
    for src_, size in ((x, half), (x[:, :half[0], :half[1]], hw), (x, hw)):
        np.testing.assert_allclose(_nhwc(PS._resize(_nchw(src_), size)),
                                   np.asarray(JS._resize(jnp.asarray(src_), size)), atol=1e-6)
    np.testing.assert_allclose(_nhwc(PS.laplacian(xt)), np.asarray(JS.laplacian(jnp.asarray(x))), atol=1e-6)
    pyr, jpyr = PS.make_laplace_pyramid(xt, 5), JS.make_laplace_pyramid(jnp.asarray(x), 5)
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(_nhwc(PS.fold_laplace_pyramid(pyr)), np.asarray(JS.fold_laplace_pyramid(jpyr)),
                               atol=1e-5)
    # a hypercolumn of three maps, the second and third at half size (the coordinates halve)
    maps = [x, rng.standard_normal((1, hw[0] // 2, hw[1] // 2, 5)).astype(np.float32),
            rng.standard_normal((1, hw[0] // 4, hw[1] // 4, 4)).astype(np.float32)]
    xx = (rng.uniform(0, 1, 50) * (hw[0] - 1)).astype(np.float32)
    yy = (rng.uniform(0, 1, 50) * (hw[1] - 1)).astype(np.float32)
    got = PS._gather_hypercolumn([_nchw(m) for m in maps], torch.tensor(xx), torch.tensor(yy))
    want = JS._gather_hypercolumn([jnp.asarray(m) for m in maps], jnp.asarray(xx), jnp.asarray(yy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _strotss_inputs(hw, seed):
    rng = np.random.default_rng(seed)
    out = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    style = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    return out, style


def _style_args(tmp_path, **kw):
    from types import SimpleNamespace

    from PIL import Image

    path = tmp_path / "style_image.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (50, 40, 3), dtype=np.uint8)).save(path)
    return SimpleNamespace(**dict(dict(style_file=str(path), styleloss_content_weight=32.0,
                                       styleloss_ospace="uniform", styleloss_skip=3, styleloss_every=2), **kw))


def test_gate_gives_zero_value_and_gradient(vggs, tmp_path):
    """The port's gate (skip 3, every 2): exactly 0 with a finite zero
    gradient where it is off, the loss where it is on; the engine's
    host-side test agrees over iterations 1-8."""
    params, vgg = vggs
    hw = (36, 48)
    out, _ = _strotss_inputs(hw, 3)
    args = _style_args(tmp_path)
    port_loss = PS.StyleLoss(args)
    port_loss.place("cpu", torch.float32, state_dict_from_flax_vgg16(params))
    draws = PS.draw_strotss(torch.Generator().manual_seed(0), *hw)
    assert [port_loss.host_active(it) for it in range(1, 9)] == [False, False, False, True, False, True, False, True]
    for it, active in ((3, False), (4, True)):
        o = torch.tensor(out[0], requires_grad=True)
        val = port_loss.get_loss({}, o, args, globals={"cur_iteration": torch.tensor(it, dtype=torch.int32),
                                                       "draws": draws})
        (g,) = torch.autograd.grad(val, o)
        assert torch.isfinite(g).all()
        if active:
            assert float(val) > 0 and g.any()
        else:
            assert float(val) == 0.0 and not g.any()


RUN = dict(prompts="sunrise", clip_models="TinyTest", size=[48, 36], num_cuts=8, batches=1, iterations=9,
           save_every=100000, display_every=100000, learning_rate_drops=[], seed=3, init_noise=None,
           vector_prompts="none", precision="fp32", save_intermediates=False, drawer="pixel", pixel_type="hex",
           pixel_size=[9, 7], custom_loss="style:0.5", styleloss_skip=4, styleloss_every=2)


def _style_png(tmp_path):
    from PIL import Image

    path = tmp_path / "style.png"
    if not path.exists():
        Image.fromarray(np.random.default_rng(5).integers(0, 256, (40, 30, 3), dtype=np.uint8)).save(path)
    return str(path)


def test_blocked_style_run_equals_single_steps(tmp_path):
    runs = {}
    for label, spc in (("blocked", 8), ("single", 1)):
        (tmp_path / label).mkdir()
        engine = Engine(apply_settings(dict(RUN, outdir=str(tmp_path / label), steps_per_call=spc,
                                            style_file=_style_png(tmp_path)), apply_side_effects=False),
                        device="cpu")
        losses = []
        for it in range(engine.args.iterations + 1):
            keep_going = engine.train(it)
            if it < engine.args.iterations:
                losses.append(engine.last_loss_values.clone())
            if not keep_going:
                break
        runs[label] = (engine, losses)
    (blocked, b_losses), (single, s_losses) = runs["blocked"], runs["single"]
    assert blocked.dispatched_blocks == [(1, 8)] and single.dispatched_blocks == []
    # the block holds active steps: the loss is taken with its device-side gate
    assert list(blocked.step_blocks) == [(8, frozenset())]
    assert blocked.loss_names == single.loss_names == ["TinyTest:prompt0", "loss:StyleLoss"]
    style = [float(v[1]) for v in s_losses]
    assert [s != 0.0 for s in style] == [False] * 4 + [True, False, True, False, True]
    for it, (a, b) in enumerate(zip(b_losses, s_losses)):
        assert torch.equal(a, b), it
    assert torch.equal(blocked.z, single.z)
    for a, b in zip(state_tensors(blocked.opt_state), state_tensors(single.opt_state)):
        assert torch.equal(a, b)


def test_inactive_block_leaves_the_loss_out(tmp_path):
    """A block whose steps all lie before ``styleloss_skip`` is dispatched without the loss."""
    engine = Engine(apply_settings(dict(RUN, outdir=str(tmp_path), steps_per_call=8, styleloss_skip=50,
                                        style_file=_style_png(tmp_path)), apply_side_effects=False), device="cpu")
    calls = []
    get_loss = engine.custom_losses[0][0].get_loss
    engine.custom_losses[0][0].get_loss = lambda *a, **k: (calls.append(1), get_loss(*a, **k))[1]
    for it in range(engine.args.iterations):
        engine.train(it)
    assert engine.dispatched_blocks == [(1, 8)] and list(engine.step_blocks) == [(8, frozenset({0}))]
    assert calls == [] and float(engine.last_loss_values[1]) == 0.0


def test_style_draws_come_last(tmp_path):
    """Per batch the fill and the cuts as before; then, after every batch,
    each batch's style draws.  A loss that does not draw leaves the stream
    as a run without custom losses draws it."""
    base = {k: v for k, v in RUN.items() if not k.startswith("styleloss")}
    base.update(outdir=str(tmp_path), batches=2, custom_loss=None)
    plain = Engine(apply_settings(base, apply_side_effects=False), device="cpu")
    sat = Engine(apply_settings(dict(base, custom_loss="saturation"), apply_side_effects=False), device="cpu")
    styled = Engine(apply_settings(dict(base, custom_loss="saturation,style", style_file=_style_png(tmp_path)),
                                   apply_side_effects=False), device="cpu")
    assert sat.step_cfg.loss_layouts == [[]] and len(styled.step_cfg.loss_layouts[1]) == 3
    for _ in range(2):
        a, b, c = plain.draw_step(), sat.draw_step(), styled.draw_step()
        for da, db, dc in zip(a, b, c):
            assert "losses" not in da and "losses" not in db and da["fill"] == db["fill"] == dc["fill"]
            for x, y, z in zip(da["perceptors"][0]["transforms"], db["perceptors"][0]["transforms"],
                               dc["perceptors"][0]["transforms"]):
                assert torch.equal(x, y) and torch.equal(x, z)
        # by hand: the two batches' style draws, after both batches' cuts
        gen = torch.Generator()
        gen.set_state(plain.gen.get_state())
        for d in c:
            want = PS.draw_strotss(gen, 36, 48)
            assert d["losses"][0] == {} and sorted(d["losses"][1]) == sorted(want)
            assert all(torch.equal(d["losses"][1][k], want[k]) for k in want)
        assert torch.equal(plain.gen.get_state(), sat.gen.get_state())
        assert torch.equal(gen.get_state(), styled.gen.get_state())
        assert torch.equal(plain.gen_device.get_state(), styled.gen_device.get_state())
        plain.gen.set_state(styled.gen.get_state())
        sat.gen.set_state(styled.gen.get_state())


def test_run_strotss_moves_the_image():
    from PIL import Image

    rng = np.random.default_rng(6)
    content = Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
    style = Image.fromarray(rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    lines = []
    out = PS.run_strotss(content, style, steps=3, progress=lines.append, device="cpu")
    assert out.shape == (36, 40, 3) and np.isfinite(out).all() and 0 <= out.min() and out.max() <= 1
    assert [s.split(":")[0] for s in lines] == ["strotss step 0", "strotss step 2"]
    start = np.clip(np.asarray(content, np.float32) / 255.0, 1e-3, 1 - 1e-3)
    assert np.abs(out - start).max() > 1e-3
