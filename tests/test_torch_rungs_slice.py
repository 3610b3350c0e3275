"""The pixel slice at ``--precision bf16`` under the JAX package's default
tower rungs (``PIXRAY_TPU_CLIP_PREC=int8b``, ``_CLIP_PREQ=1``,
``_CLIP_LN32=0``) against the JAX engine on the CPU, the JAX engine's own
draws injected into the port (TinyTest, 96x54, 8 cuts, 3 steps).

The JAX engine's warp is exact on the CPU (it has no Pallas kernel
there), so the port's warp rung here is ``highest``; the epilogue is
float32 on the CPU in both.  The port gets the JAX tower's float32
weights, which both packages pre-quantize.

Each step starts from the JAX engine's latent and Adam state, and is held
to: the loss within 3e-3 (measured up to 2.4e-3; the port at the bf16
rung against the JAX engine at int8b: 4e-3 to 6e-3); the latent's update
at a cosine of at least 0.95 to the JAX update (measured 0.982 at the
first step, where Adam's update is the gradient's sign times the rate,
then 0.999), and no element of it more than twice the learning rate (plus
1e-3) from the JAX element.  Both towers compute in bf16 and round some
sums in other places (XLA keeps float32 intermediates of a fused bf16
chain; the embeddings alone differ by up to ~1e-2 in
tests/test_torch_tower_rungs.py), and an element whose gradient is near
0 can take Adam's step in the other direction.
"""

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import SLICE, _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

LOSS_ATOL = 3e-3
UPDATE_COSINE = 0.95
JAX_TOWER_RUNGS = {"PIXRAY_TPU_CLIP_PREC": "int8b", "PIXRAY_TPU_CLIP_PREQ": "1", "PIXRAY_TPU_CLIP_LN32": "0"}


def test_int8b_pixel_slice_matches_jax_engine(tmp_path, monkeypatch):
    for name, value in dict(JAX_TOWER_RUNGS, PIXRAY_TPU_WARP_PREC="highest").items():
        monkeypatch.setenv(name, value)
    cfg = dict(SLICE, precision="bf16")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    jp = ref.perceptors[0]
    assert "quant" in jp.variables
    weights = {"TinyTest": state_dict_from_flax(jp._load_variables("TinyTest")["params"], jp.config)}
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    p = port.perceptors[0]
    assert (p.dtype, p.quant, p.rungs.clip_ln32, port.rungs.warp) == (torch.bfloat16, "int8b", False, "highest")
    lr = port.drawer.learning_rate  # the pixel drawer brings its own rate
    for it in range(cfg["iterations"]):
        # every step from the JAX engine's state: the towers' bf16 roundings
        # differ, and Adam would carry that difference from step to step
        z0 = np.asarray(ref.z)
        with torch.no_grad():
            port.z.copy_(torch.tensor(z0))
            for dst, src in zip(port.optimizer.jax_leaves(port.opt_state), jax.tree_util.tree_leaves(ref.opt_state)):
                dst.copy_(torch.tensor(np.asarray(src)))
        _, k_step = jax.random.split(ref.key)
        draws = _jax_step_draws(k_step, [32], cfg["num_cuts"], 96 / 54, cfg["batches"])
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=LOSS_ATOL)
        up, ref_up = (port.z.numpy() - z0).ravel(), (np.asarray(ref.z) - z0).ravel()
        assert up @ ref_up / np.linalg.norm(up) / np.linalg.norm(ref_up) >= UPDATE_COSINE
        assert np.abs(up - ref_up).max() <= 2 * lr + 1e-3
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0"]
