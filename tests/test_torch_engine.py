"""Port engine against the JAX engine: settings resolution, Adam, and the
pixel slice end to end (TinyTest perceptor, 96x54 canvas, 8 cuts, 3 steps,
float32) with the JAX engine's own random draws injected into the port.

Slice tolerances: per-step loss 1e-4 and latent 1e-3.  Both runs are f32;
the warp, pooling and tower sum in other orders (~1e-6 relative), and Adam
normalizes each element's gradient, so an element whose gradient is tiny
moves by up to lr·Δg/|g| — the latent bound covers that with margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine import cutouts as JC
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.engine.core import resolve_seed as j_resolve_seed
from pixray_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from pixray_tpu.engine.optimizers import set_learning_rate as j_set_learning_rate
from pixray_tpu.ops.color import _draw_jitter_params
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine, resolve_seed
from pixray_tpu_torch.engine.optimizers import build_optimizer, set_learning_rate
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

SLICE = dict(
    drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[96, 54], num_cuts=8,
    batches=1, iterations=3, save_every=100000, display_every=100000, init_noise=None,
    vector_prompts="none", seed=1, save_intermediates=False, learning_rate_drops=[],
    precision="fp32", shard_cutouts=False, steps_per_call=1,
)


@pytest.mark.parametrize("settings", [
    dict(drawer="pixel", prompts="sunrise|a red barn:0.5", size=[384, 216], num_cuts=64, seed=1,
         learning_rate_drops=[50, "80%"], save_every="10%"),
    dict(drawer="pixel", prompts="sunrise", quality="draft", aspect="square", pixel_size=[20, 10],
         vector_prompts="textoff", init_noise="none", iterations=40),
])
def test_settings_resolve_like_jax(settings):
    port = vars(apply_settings(dict(settings), apply_side_effects=False))
    ref = vars(j_apply_settings(dict(settings), apply_side_effects=False))
    assert port == ref


def test_settings_refuse_unported():
    with pytest.raises(NotImplementedError):
        apply_settings(dict(drawer="no_such_drawer", prompts="x"), apply_side_effects=False)
    with pytest.raises(NotImplementedError, match="style"):
        apply_settings(dict(drawer="pixel", prompts="x", custom_loss="saturation,style:0.5"), apply_side_effects=False)
    for ported in (dict(drawer="vqgan", prompts="x"), dict(drawer="fft", prompts="x"),
                   dict(drawer="fast_pixel", prompts="x", palette="black->white", filters="lookup",
                        custom_loss="palette:2,edge->a"),
                   dict(drawer="vdiff", prompts="x", vdiff_model="cc12m_1", vdiff_schedule="log", vdiff_skip=25),
                   dict(drawer="super_resolution", prompts="x")):
        assert vars(apply_settings(dict(ported), apply_side_effects=False)) == vars(
            j_apply_settings(dict(ported), apply_side_effects=False))


@pytest.mark.parametrize("seed", [None, 7, "123", "a sunrise"])
def test_resolve_seed(seed):
    if seed is None:
        assert 0 <= resolve_seed(seed) < 2**32
    else:
        assert resolve_seed(seed) == j_resolve_seed(seed)


def test_adam_and_set_learning_rate_match_optax():
    rng = np.random.default_rng(0)
    z = rng.random((50, 4)).astype(np.float32)
    grads = [rng.standard_normal((50, 4)).astype(np.float32) * s for s in (1.0, 1e-3, 5.0)]
    opt = j_build_optimizer("Adam", 0.03)
    state = opt.init(jnp.asarray(z))
    port = build_optimizer("Adam", 0.03)
    pstate = port.init(torch.tensor(z))
    jz, pz = jnp.asarray(z), torch.tensor(z)
    for i, g in enumerate(grads):
        if i == 2:  # an LR drop in the middle of the run
            state = j_set_learning_rate(state, 0.003)
            pstate = set_learning_rate(pstate, 0.003)
        upd, state = opt.update(jnp.asarray(g), state, jz)
        jz = optax.apply_updates(jz, upd)
        pupd, pstate = port.update(torch.tensor(g), pstate)
        pz = pz + pupd
        np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=1e-6)


def _jax_step_draws(k_step, cut_sizes, num_cuts, aspect, batches):
    """The draws of one JAX step, split exactly as pixray_tpu's step, loss_fn
    and render_cutouts split them (one cut size per perceptor, nchw bank)."""
    return [_jax_batch_draws(key, cut_sizes, num_cuts, aspect)
            for key in jax.random.split(k_step, batches)]


def _jax_batch_draws(key, cut_sizes, num_cuts, aspect):
    _k_synth, k_fill, _k_loss, *pks = jax.random.split(key, 3 + len(cut_sizes))
    return {
        "fill": float(jax.random.uniform(k_fill)),
        "perceptors": [_jax_perceptor_draws(pk, s, num_cuts, aspect) for pk, s in zip(pks, cut_sizes)],
    }


def _jax_perceptor_draws(pk, cut_size, num_cuts, aspect):
    k_t, k_jit, k_noise, *_ = jax.random.split(pk, 6)
    zoom, wide = JC.sample_cut_transforms(k_t, cut_size, num_cuts, aspect)
    hs, sf, ap = jax.vmap(lambda k: _draw_jitter_params(k, 0.1, 0.1, 0.8))(jax.random.split(k_jit, num_cuts))
    k_fac, k_planes = jax.random.split(k_noise)
    facs = jax.random.uniform(k_fac, (num_cuts, 1, 1), maxval=JC.NOISE_FAC, dtype=jnp.float32)
    planes = [jax.random.normal(kp, (num_cuts, cut_size, cut_size), dtype=jnp.float32)
              for kp in jax.random.split(k_planes, 3)]
    t = lambda a: torch.tensor(np.asarray(a))
    return {
        "transforms": (t(zoom), t(wide)),
        "jitter": (t(hs), t(sf), t(ap)),
        "noise": (t(facs), [t(p) for p in planes]),
    }


def test_jax_draws_of_one_perceptor_use_the_fourth_key():
    """With one perceptor the step key splits in 4 (synth, fill, loss,
    perceptor), as the single-perceptor slices were written against."""
    key = jax.random.PRNGKey(5)
    draws = _jax_batch_draws(key, [32], 8, 96 / 54)
    _, k_fill, _, pk = jax.random.split(key, 4)
    ref = _jax_perceptor_draws(pk, 32, 8, 96 / 54)
    assert draws["fill"] == float(jax.random.uniform(k_fill))
    for got, want in zip(draws["perceptors"][0]["transforms"] + draws["perceptors"][0]["jitter"],
                         ref["transforms"] + ref["jitter"]):
        assert torch.equal(got, want)


# the main-path terms only; then the other terms of the slice's loss
# (transparency, init_weight_dist/cos) with gradient accumulation.
# init_weight is held against JAX in test_init_weight_term: at step 0 the
# latent equals its origin and JAX's norm gradient there is NaN.
TERMS = {
    "prompt": ({}, ["TinyTest:prompt0"]),
    "more_terms": (dict(batches=2, iterations=2, transparent=True, transparent_weight=0.5,
                        init_weight_dist=0.2, init_weight_cos=0.1),
                   ["TinyTest:prompt0", "init_weight_dist", "init_weight_cos", "transparent"]),
}


@pytest.mark.parametrize("terms", list(TERMS))
def test_pixel_slice_matches_jax_engine(tmp_path, terms):
    extra, names = TERMS[terms]
    cfg = dict(SLICE, **extra)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    jp = ref.perceptors[0]
    weights = {"TinyTest": state_dict_from_flax(jp.variables["params"], jp.config)}
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))
    for it in range(cfg["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32], cfg["num_cuts"], 96 / 54, cfg["batches"])
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        np.testing.assert_allclose(port.z.numpy(), np.asarray(ref.z), atol=1e-3)
    assert port.loss_names == ref.loss_names == names
    assert (tmp_path / "port" / "output.png").exists()


def test_init_weight_term():
    """The init_weight loss and its gradient match JAX's away from the origin;
    at the origin (every run's first step) the port's gradient is 0 where
    JAX's is NaN (the norm's gradient at a zero vector)."""
    from pixray_tpu.ops.grad import spherical_dist_loss as j_sdl
    from pixray_tpu_torch.ops.grad import spherical_dist_loss

    rng = np.random.default_rng(2)
    z0 = rng.random((1, 40)).astype(np.float32)
    z = (z0 + 0.05 * rng.standard_normal((1, 40))).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda v: jnp.mean(j_sdl(v, jnp.asarray(z0))) * 0.3)(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    loss = torch.mean(spherical_dist_loss(zt, torch.tensor(z0))) * 0.3
    (g,) = torch.autograd.grad(loss, zt)
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5)
    at_origin = torch.tensor(z0, requires_grad=True)
    (g0,) = torch.autograd.grad(torch.mean(spherical_dist_loss(at_origin, torch.tensor(z0))), at_origin)
    assert torch.equal(g0, torch.zeros_like(g0))
    assert np.isnan(np.asarray(jax.grad(lambda v: jnp.mean(j_sdl(v, jnp.asarray(z0))))(jnp.asarray(z0)))).all()


def test_vector_prompt_tables_match_jax(tmp_path):
    import json
    from types import SimpleNamespace

    from pixray_tpu.engine.prompts import build_prompt_tables as j_tables
    from pixray_tpu_torch.engine.prompts import build_prompt_tables

    rng = np.random.default_rng(1)
    path = tmp_path / "dir.json"
    path.write_text(json.dumps({"TinyTest": rng.standard_normal((2, 32)).tolist(), "Other": [[0.0]]}))
    args = SimpleNamespace(prompts=[], vector_prompts=[f"{path}:0.5:-2", "no_such_vector"],
                           spot_prompts=[], spot_prompts_off=[], labels=[], noise_prompt_seeds=[],
                           animation_dir=None)
    perceptor = SimpleNamespace(name="TinyTest", output_dim=32)
    ref = j_tables(args, [perceptor])[0]["TinyTest"]
    port = build_prompt_tables(args, [perceptor])[0]["TinyTest"]
    for field in ("embeds", "weights", "stops"):
        np.testing.assert_array_equal(getattr(port, field).numpy(), np.asarray(getattr(ref, field)))


def test_checkin_png_carries_provenance(tmp_path):
    """The zlib/struct PNG decodes to the JAX package's pixels and carries the
    same pixray_* text chunks as its PIL-built one."""
    from PIL import Image

    from pixray_tpu.io.images import from_tensor
    from pixray_tpu.utils.provenance import build_png_info
    from pixray_tpu_torch.io.output import png_text, save_png

    rng = np.random.default_rng(0)
    arr = rng.uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    given = {"prompts": ["sunrise", "café"], "size": [13, 9], "drawer": "pixel"}
    path = tmp_path / "out.png"
    save_png(arr, str(path), png_text(given, 1234))
    img = Image.open(path)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(from_tensor(arr)))
    ref = {k.decode(): v for k, v in (
        (c[1].split(b"\0", 1)[0], c[1].split(b"\0", 1)[1]) for c in build_png_info(given, 1234).chunks)}
    port = {k: v for k, v in img.text.items() if k != "Software"}
    assert port == {k: v.decode("latin-1") for k, v in ref.items() if k != "Software"}
