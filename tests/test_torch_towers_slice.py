"""Three tower families in one run, on the CPU in float32: the pixel slice
(96x54, 8 cuts, 3 steps) under the tiny ResNet (32 px), the tiny timm trunk
(48 px, ImageNet statistics) and TinyTest (32 px), the port's ``Engine``
against the JAX ``Engine`` with the JAX engine's own draws replayed in the
port and its weights (``params`` and ``batch_stats``) carried across by the
bridge; then ``--steps_per_call`` 8 against 1 in the port, bitwise.

The JAX engine feeds a ResNet a channels-last bank, whose noise is one
(N, S, S, 3) normal draw instead of three (N, S, S) planes: the replayed
draws carry that draw's channels as the ResNet's planes.

Tolerances as tests/test_torch_engine.py: per-step loss 1e-4, latent 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.latent import leaves
from pixray_tpu_torch.engine.optimizers import state_tensors
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import _jax_step_draws
from torch_parity import jax_perceptor_cache, tiny_towers  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache", "tiny_towers")

TOWERS = "TinyRN,TinyTimm48,TinyTest"
SLICE = dict(
    drawer="pixel", prompts="sunrise", clip_models=TOWERS, size=[96, 54], num_cuts=8, batches=1, iterations=3,
    save_every=100000, display_every=100000, init_noise=None, vector_prompts="none", seed=1,
    save_intermediates=False, learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
)


def _jax_draws(k_step, cut_sizes, resnets):
    """One step's draws (one batch) as the JAX step splits them."""
    draws = _jax_step_draws(k_step, cut_sizes, SLICE["num_cuts"], 96 / 54, 1)
    (key,) = jax.random.split(k_step, 1)
    for pd, pk, size, nhwc in zip(draws[0]["perceptors"], jax.random.split(key, 3 + len(cut_sizes))[3:],
                                  cut_sizes, resnets):
        if nhwc:
            _, k_planes = jax.random.split(jax.random.split(pk, 6)[2])
            noise = np.asarray(jax.random.normal(k_planes, (SLICE["num_cuts"], size, size, 3)))
            pd["noise"] = (pd["noise"][0], [torch.tensor(noise[..., c]) for c in range(3)])
    return draws


def test_three_tower_families_match_jax_engine(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(SLICE, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    weights = {p.name: state_dict_from_flax(p.variables, p.config) for p in ref.perceptors}
    port = Engine(apply_settings(dict(SLICE, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    assert [p.input_resolution for p in port.perceptors] == [32, 48, 32]
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))
    for it in range(SLICE["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = _jax_draws(k_step, [32, 48, 32], [True, False, False])
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        np.testing.assert_allclose(port.z.numpy(), np.asarray(ref.z), atol=1e-3)
    assert port.loss_names == ref.loss_names == [f"{n}:prompt0" for n in TOWERS.split(",")]


def _run(tmp_path, label, steps_per_call):
    (tmp_path / label).mkdir()
    engine = Engine(apply_settings(dict(SLICE, iterations=10, outdir=str(tmp_path / label),
                                        steps_per_call=steps_per_call), apply_side_effects=False), device="cpu")
    losses = []
    for it in range(10):
        engine.train(it)
        losses.append(engine.last_loss_values.clone())
    return engine, losses


def test_blocked_equals_single_steps(tmp_path):
    blocked, b_losses = _run(tmp_path, "blocked", 8)
    single, s_losses = _run(tmp_path, "single", 1)
    assert blocked.dispatched_blocks == [(1, 8)] and single.dispatched_blocks == []
    for it, (a, b) in enumerate(zip(b_losses, s_losses)):
        assert torch.equal(a, b), it
    for a, b in zip(leaves(blocked.z) + state_tensors(blocked.opt_state),
                    leaves(single.z) + state_tensors(single.opt_state)):
        assert torch.equal(a, b)
