"""The vqgan slice end to end against the JAX engine on the CPU: the
tiny_test VQGAN under two perceptors of two resolutions (TinyTest 32 px,
TinyTest48 48 px), an off-grid 49x33 canvas (so the init noise goes
through the Lanczos resize, then the encoder), 8 cuts, 3 steps, float32,
with the JAX engine's own draws replayed in the port.

The JAX engine loads the weights from a taming-style checkpoint file; the
port gets the same weights bridged from the JAX drawer through
``Engine(..., state_dicts={"vqgan": ...})``.  The codebook is drawn wide
(normal, std 0.5) so that the nearest code of the encoded init wins by far
more than f32 rounding (see tests/test_torch_vqgan.py).

The vector prompt is the default ``textoff``, read from a file that holds
a seeded vector for each tiny tower, so the loss names and terms follow
the default run's order: each perceptor's text prompt, then its vector
prompt.

Tolerances as tests/test_torch_engine.py: per-step loss 1e-4, latent
1e-3; the initial latent is the same codes (to 1e-6).  The learning rate
is the pixel slice's 0.03, not vqgan's 0.2: Adam moves an element whose
gradient is near its eps by up to lr·Δg/|g|, and at 0.2 two such elements
of the 12,288 differ by 3.3e-3 after the first step.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.vqgan import VQGAN_CONFIGS, state_dict_from_flax_vqgan
from test_torch_engine import _jax_step_draws
from test_torch_vqgan import _assert_same_codes, _taming_weights
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

SLICE = dict(
    drawer="vqgan", vqgan_model="tiny_test", prompts="sunrise", clip_models="TinyTest,TinyTest48",
    size=[49, 33], num_cuts=8, batches=1, iterations=3, save_every=100000, display_every=100000,
    init_noise="pixels", seed=1, save_intermediates=False,
    learning_rate=0.03, learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
)


def test_vqgan_slice_matches_jax_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("PIXRAY_TPU_PALLAS", "0")  # the XLA warp, as on the CPU anyway
    vectors = np.random.default_rng(3).standard_normal((2, 1, 32))
    (tmp_path / "textoff.json").write_text(json.dumps({"TinyTest": vectors[0].tolist(),
                                                        "TinyTest48": vectors[1].tolist()}))
    monkeypatch.setenv("PIXRAY_TPU_VECTORS", str(tmp_path))
    ckpt = tmp_path / "tiny.ckpt"
    weights = _taming_weights(VQGAN_CONFIGS["tiny_test"], 2)
    torch.save({"state_dict": {k: torch.tensor(a) for k, a in weights.items()}}, ckpt)
    cfg = dict(SLICE, vqgan_checkpoint=str(ckpt))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    state_dicts = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    state_dicts["vqgan"] = state_dict_from_flax_vqgan(ref.drawer.model_params["params"], ref.drawer.config)
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=state_dicts)

    assert (port.side_x, port.side_y) == (ref.side_x, ref.side_y) == (48, 32)
    codebook = np.asarray(ref.drawer.model_params["params"]["codebook"])
    _assert_same_codes(port.z.numpy(), np.asarray(ref.z), codebook)
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))

    for it in range(cfg["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32, 48], cfg["num_cuts"], 49 / 33, cfg["batches"])
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        np.testing.assert_allclose(port.z.numpy(), np.asarray(ref.z), atol=1e-3)
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0", "TinyTest:prompt1",
                                                 "TinyTest48:prompt0", "TinyTest48:prompt1"]
    port.cur_iteration = cfg["iterations"]
    port.run()  # the final checkin
    assert (tmp_path / "port" / "output.png").exists()
