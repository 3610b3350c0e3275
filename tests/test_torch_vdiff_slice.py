"""The vdiff slice end to end against the JAX engine on the CPU: a tiny
modulated (cc12m-family) upstream UNet under TinyTest, on a 48x32 canvas
(the generated canvas is 128x128), 3 iterations in float32, so the steps
run at schedule entries 0-2 and every ``post_step`` from step 1 re-noises
(the last one reads ``alphas[4]``, past the end); the JAX engine's cut draws and its
``PRNGKey(iteration)`` re-noise draws replayed in the port.

The JAX package's own ``tiny_up_mod`` takes a 12-wide clip embedding
while TinyTest gives 32, so neither engine can run it under TinyTest
(``test_tiny_up_mod_under_tinytest_fails_in_both``).  The slice runs the
same spec with the conditioning 32 wide, ``tiny_up_mod32``, put into both
packages' tables for this module.

Held to the JAX run: the clip embedding (1e-6), per-step losses (1e-4),
each step's learning rate (the drawer's and the optimizer's, to 1e-5
relative: the schedules' arccos may round one ulp otherwise, which moves
sigma / alpha by ~1e-7 of itself) and the latent after every step, under
the default schedule (the log schedule and ``--vdiff_skip`` are held at
the drawer level in ``test_torch_vdiff.py``: an engine slice costs a JAX
step compile).  The latent within 1e-3
but at 0.1% of its elements at most, as in the image slice: Adam's step
(up to twice the learning rate) can go either way on an element whose
gradient is ~1e-7, and the re-noising carries that gap on, so such an
element is held to twice the sum of the learning rates so far.
"""

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.models import vdiff_upstream as JU
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models import vdiff_upstream as PU
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

SLICE = dict(
    drawer="vdiff", vdiff_model="tiny_up_mod32", prompts="sunrise|a barn:0.5", clip_models="TinyTest",
    size=[48, 32], num_cuts=8, batches=1, iterations=3, save_every=100000, display_every=100000, init_noise=None,
    seed=1, save_intermediates=False, learning_rate_drops=[], precision="fp32", vector_prompts="none",
)

TINY_MOD32 = dict(clip_embed_dim=32, mapping_width=16, mapping_ff=8, clip_model="TinyTest")


@pytest.fixture(scope="module")
def tiny_up_mod32():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (JU, PU):
            mp.setitem(pkg.UPSTREAM_SPECS, "tiny_up_mod32",
                       pkg.build_spec("tiny_up_mod32", 32, (8, 16), (1,), "modconv", **TINY_MOD32))
        yield


def _engines(tmp_path, monkeypatch, **kw):
    """Both engines, the UNet's weights read by each from one ``.pth`` under
    ``$PIXRAY_TPU_MODELS`` (seeded; the JAX package's random init compiles a
    draw per shape), the tower's bridged from the JAX engine's."""
    cfg = dict(SLICE, **kw)
    for d in ("jax", "port", "models"):
        (tmp_path / d).mkdir()
    name = cfg["vdiff_model"]
    with torch.device("meta"):
        model = PU.VDiffUpstream(PU.UPSTREAM_SPECS[name])
    PU.init_random_(model.to_empty(device="cpu"), torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), tmp_path / "models" / f"{name}.pth")
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path / "models"))
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    state_dicts = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=state_dicts)
    assert port.drawer.model.state_dict().keys() == ref.drawer.model_params["unet"].keys()
    return cfg, ref, port


def test_vdiff_slice_matches_jax_engine(tmp_path, monkeypatch, tiny_up_mod32):
    cfg, ref, port = _engines(tmp_path, monkeypatch)
    np.testing.assert_allclose(port.drawer.model_params["clip_embed"].numpy(),
                               np.asarray(ref.drawer.model_params["clip_embed"]), atol=1e-6)
    assert port.z.shape == ref.z.shape == (1, 128, 128, 3)
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)

    moved = 0.0  # the sum of the learning rates so far: how far an element Adam steps apart can drift
    for it in range(cfg["iterations"] + 1):
        moved += 2 * float(port.opt_state.learning_rate) if it < cfg["iterations"] else 0.0
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32], cfg["num_cuts"], 48 / 32, cfg["batches"])
        renoise = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(it), ref.z.shape)))
        ref_on = ref.train(it)
        port_on = port.train(it, draws, renoise=renoise)
        assert port_on == ref_on == (it < cfg["iterations"])
        if it < cfg["iterations"]:
            np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        assert port.drawer.learning_rate == pytest.approx(ref.drawer.learning_rate, rel=1e-5, abs=0)
        assert float(port.opt_state.learning_rate) == pytest.approx(
            float(ref.opt_state.hyperparams["learning_rate"]), rel=1e-5, abs=0)
        diff = np.abs(port.z.numpy() - np.asarray(ref.z))
        assert (diff > 1e-3).mean() <= 1e-3 and diff.max() <= moved, (it, int((diff > 1e-3).sum()), diff.max())
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0", "TinyTest:prompt1"]
    assert port.drawer.learning_rate < 0.01  # the schedule set it, from step 1 on
    assert (tmp_path / "port" / "output.png").exists()


def test_tiny_up_mod_under_tinytest_fails_in_both(tmp_path, monkeypatch):
    cfg = dict(SLICE, vdiff_model="tiny_up_mod", iterations=1)
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    with torch.device("meta"):
        model = PU.VDiffUpstream(PU.UPSTREAM_SPECS["tiny_up_mod"])
    torch.save(PU.init_random_(model.to_empty(device="cpu"), torch.Generator().manual_seed(5)).state_dict(),
               tmp_path / "tiny_up_mod.pth")
    with pytest.raises(ValueError, match="12-wide clip embedding"):
        Engine(apply_settings(dict(cfg, outdir=str(tmp_path)), apply_side_effects=False), device="cpu")
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path)), apply_side_effects=False))
    with pytest.raises(TypeError):  # the mapping network's matmul: 32 + 8 inputs against 12 + 8
        ref.train(0)
