"""The image slice end to end against the JAX engine on the CPU, with the
JAX engine's own draws replayed in the port (the main cuts, and the noise
of the spot, spot_off and image-prompt banks, and under
``--image_prompt_shuffle`` each image prompt's own cuts):

- pixel 48x32 from an init image (``--init_image_alpha`` 90), two image
  prompts (with and without ``--image_prompt_shuffle``), a spot and a
  spot_off prompt on the package's mask, a target image and
  ``--init_weight_pix``, TinyTest, 8 cuts, 3 steps;
- the tiny_test VQGAN of tests/test_torch_vqgan_slice.py (two towers, the
  wide codebook) with an overlay every 2 steps (an RGBA image pasted over
  the canvas and re-encoded before steps 0 and 2) and an image label.

Per-step loss within 1e-4, as tests/test_torch_plugins_slice.py holds it,
and the latent within 1e-3 but at 0.1% of its elements at most, which Adam
may step apart by up to twice the learning rate (an element whose
gradient is ~1e-7 can change sign between the packages); the term names
equal.  The
port pools each image prompt once per run where the JAX step pools it in
every step: the pooled images are held to the JAX step's pooling (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine import cutouts as JC
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.vqgan import VQGAN_CONFIGS, state_dict_from_flax_vqgan
from test_torch_engine import _jax_perceptor_draws
from test_torch_vqgan import _assert_same_codes, _taming_weights
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")


def write_png(path, shape, mode, seed, alpha=None):
    arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    if alpha is not None:
        arr[..., 3] = alpha
    Image.fromarray(arr, mode).save(path)
    return str(path)


def _jax_noise(key, n, s):
    t = lambda a: torch.tensor(np.asarray(a))
    k_fac, k_planes = jax.random.split(key)
    facs = jax.random.uniform(k_fac, (n, 1, 1), maxval=JC.NOISE_FAC, dtype=jnp.float32)
    return t(facs), [t(jax.random.normal(kp, (n, s, s), dtype=jnp.float32)) for kp in jax.random.split(k_planes, 3)]


def jax_image_draws(k_step, specs, num_cuts, aspect, batches, shuffle):
    """One JAX step's draws with the banks that reuse the main cuts: per
    perceptor key, split in six (cuts, jitter, noise, spot noise, spot_off
    noise, image-prompt keys), the image prompts' noise from
    ``split(k_img, K + 1)[k]`` and their shuffled cuts from
    ``fold_in(split(k_img, K + 1)[-1], k)``."""
    out = []
    for key in jax.random.split(k_step, batches):
        _k_synth, k_fill, _k_loss, *pks = jax.random.split(key, 3 + len(specs))
        perceptors = []
        for pk, spec in zip(pks, specs):
            s = spec.cut_size
            d = _jax_perceptor_draws(pk, s, num_cuts, aspect)
            _, _, _, k_spot, k_spot_off, k_img = jax.random.split(pk, 6)
            if spec.spot_banks[0]:
                d["spot"] = _jax_noise(k_spot, num_cuts, s)
            if spec.spot_banks[1]:
                d["spot_off"] = _jax_noise(k_spot_off, num_cuts, s)
            n_img = spec.n_image_prompts
            if n_img:
                k_imgs = jax.random.split(k_img, n_img + 1)
                d["image_prompts"] = []
                for k in range(n_img):
                    transforms = None
                    if shuffle:
                        zoom, wide = JC.sample_cut_transforms(jax.random.fold_in(k_imgs[-1], k), s, num_cuts, aspect)
                        transforms = (torch.tensor(np.asarray(zoom)), torch.tensor(np.asarray(wide)))
                    d["image_prompts"].append({"transforms": transforms, "noise": _jax_noise(k_imgs[k], num_cuts, s)})
            perceptors.append(d)
        out.append({"fill": float(jax.random.uniform(k_fill)), "perceptors": perceptors})
    return out


def _run_both(tmp_path, cfg, state_dicts=None):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    weights = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    weights.update(state_dicts or {})
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    return ref, port


def _step_both(ref, port, cfg, aspect):
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))
    for it in range(cfg["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = jax_image_draws(k_step, port.step_cfg.perceptors, cfg["num_cuts"], aspect, cfg["batches"],
                                cfg.get("image_prompt_shuffle", False))
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4,
                                   err_msg=f"step {it}")
        # Adam's first step is lr * g / (|g| + eps): an element whose gradient
        # is ~1e-7, where the two packages' sums round apart, may step either
        # way by up to lr.  The rest of the latent within 1e-3.
        diff = np.abs(port.z.numpy() - np.asarray(ref.z))
        lr = port.args.learning_rate
        assert (diff > 1e-3).mean() <= 1e-3 and diff.max() <= 2 * lr, (it, int((diff > 1e-3).sum()), diff.max())


PIXEL = dict(
    drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[48, 32], num_cuts=8, batches=1,
    iterations=3, save_every=100000, display_every=100000, init_noise="pixels", vector_prompts="none",
    seed=1, save_intermediates=False, learning_rate_drops=[], precision="fp32", shard_cutouts=False,
    steps_per_call=1, init_image_alpha=90, spot_prompts="a face", spot_prompts_off="sky:0.5",
    init_weight_pix=0.5, image_prompt_weight=0.7,
)


@pytest.mark.parametrize("shuffle", [False, True], ids=["same_cuts", "shuffle"])
def test_pixel_image_slice_matches_jax_engine(tmp_path, shuffle):
    cfg = dict(PIXEL, image_prompt_shuffle=shuffle,
               init_image=write_png(tmp_path / "init.png", (40, 60, 3), "RGB", 1),
               image_prompts=str(tmp_path / "prompt{0,1}.png"),
               target_images=write_png(tmp_path / "target.png", (33, 45, 3), "RGB", 4))
    write_png(tmp_path / "prompt0.png", (30, 30, 4), "RGBA", 2)
    write_png(tmp_path / "prompt1.png", (50, 20, 3), "RGB", 3)
    ref, port = _run_both(tmp_path, cfg)
    assert port.args.image_prompts == ref.args.image_prompts and len(port.args.image_prompts) == 2
    spec = port.step_cfg.perceptors[0]
    assert spec.banks == 5  # main, spot, spot_off, two image prompts
    for k, img in enumerate(ref.refs["image_prompts"]["TinyTest"]):
        want = JC.pool_to_work(img, 32, ref.step_cfg.aspect)
        np.testing.assert_allclose(spec.image_prompts[k].numpy(), np.asarray(want), atol=1e-6)
    j_spec = ref.step_cfg.perceptors[0]
    np.testing.assert_array_equal(spec.spot_keep_on.numpy(), np.asarray(j_spec.spot_keep_on))
    np.testing.assert_array_equal(spec.spot_keep_off.numpy(), np.asarray(j_spec.spot_keep_off))
    _step_both(ref, port, cfg, 48 / 32)
    assert port.loss_names == ref.loss_names == [
        "TinyTest:prompt0", "TinyTest:prompt1", "TinyTest:spot0", "TinyTest:spot_off0",
        "TinyTest:image_prompt0", "TinyTest:image_prompt1", "init_weight_pix"]


def test_init_weight_pix_gradient_at_its_image():
    """A canvas equal to its init image: JAX's |d| takes the gradient +1 at
    0, so every pixel's gradient is +w / (2 N), as the port's."""
    from pixray_tpu_torch.engine.step import StepConfig, loss_fn

    img0 = torch.rand((6, 5, 3), generator=torch.Generator().manual_seed(0))

    class Drawer:
        def synth(self, params, z, iteration=None):  # the drawers' synth takes the step's iteration
            return z

    cfg = StepConfig(drawer=Drawer(), drawer_params={}, perceptors=[], batches=1, init_weight_pix=0.5,
                     init_image=img0)
    z = img0.clone().requires_grad_(True)
    total, _ = loss_fn(cfg, z, {"filters": [], "fill": 0.0, "iteration": 0, "perceptors": []})
    (g,) = torch.autograd.grad(total, z)
    want = jax.grad(lambda x: jnp.mean(jnp.abs(x - jnp.asarray(img0.numpy()))) * 0.5 / 2)(jnp.asarray(img0.numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert float(g.min()) == float(g.max()) == np.float32(0.25 / img0.numel())
    assert cfg.names == ["init_weight_pix"]


VQGAN = dict(
    drawer="vqgan", vqgan_model="tiny_test", prompts="sunrise", clip_models="TinyTest,TinyTest48",
    size=[49, 33], num_cuts=8, batches=1, iterations=4, save_every=100000, display_every=100000,
    init_noise="pixels", seed=1, save_intermediates=False, vector_prompts="none",
    learning_rate=0.03, learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
    overlay_every=2, image_label_weight=0.8,
)


def test_vqgan_overlay_and_labels_match_jax_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("PIXRAY_TPU_PALLAS", "0")  # the XLA warp, as on the CPU anyway
    ckpt = tmp_path / "tiny.ckpt"
    weights = _taming_weights(VQGAN_CONFIGS["tiny_test"], 2)
    torch.save({"state_dict": {k: torch.tensor(a) for k, a in weights.items()}}, ckpt)
    cfg = dict(VQGAN, vqgan_checkpoint=str(ckpt),
               overlay_image=write_png(tmp_path / "overlay.png", (20, 30, 4), "RGBA", 5, alpha=160),
               image_labels=write_png(tmp_path / "label.png", (40, 40, 3), "RGB", 6))
    (tmp_path / "w").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "w")), apply_side_effects=False))
    vqgan = state_dict_from_flax_vqgan(ref.drawer.model_params["params"], ref.drawer.config)
    del ref
    ref, port = _run_both(tmp_path, cfg, {"vqgan": vqgan})
    codebook = np.asarray(ref.drawer.model_params["params"]["codebook"])
    _assert_same_codes(port.z.numpy(), np.asarray(ref.z), codebook)
    np.testing.assert_allclose(port.z_labels[0].numpy(), np.asarray(ref.z_labels[0]), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(port.overlay_image_rgba), np.asarray(ref.overlay_image_rgba))
    # The overlay re-encodes the canvas after its uint8 truncation (* 255.999),
    # which turns the decoders' ~1e-6 apart into one level at a few pixels;
    # with random weights a token of the re-encoded latent can sit that close
    # to a code tie.  So the port re-encodes the JAX engine's canvas, after
    # holding its own to it within one level at under 0.1% of the values.
    canvases, own = [], []
    j_overlay, p_synth = ref.re_average_z, port.synth_image

    def record():
        canvases.append(ref.synth_image())
        j_overlay()

    def replay():
        own.append(np.abs(np.asarray(p_synth(), int) - np.asarray(canvases[-1], int)))
        return canvases[-1].copy()

    ref.re_average_z, port.synth_image = record, replay
    _step_both(ref, port, cfg, 49 / 33)
    assert len(canvases) == len(own) == 2  # before steps 0 and 2
    for diff in own:
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0", "TinyTest48:prompt0", "image_label0"]
