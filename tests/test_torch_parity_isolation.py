"""The JAX package's perceptor cache against the port's parity tests.

``pixray_tpu.models.perceptor.get_clip_perceptor`` caches a tower by name
alone: a bf16 ``TinyTest`` that a JAX-package test cached first comes back
to a JAX Engine that asks for float32, and a parity test then holds the
f32 port against a bf16 reference (per-term losses ~5e-3 apart at step 0).
The parity tests take the ``jax_perceptor_cache`` fixture
(``tests/torch_parity.py``), which gives each test an empty cache of its
own.

- Under the fixture, after a bf16 ``TinyTest`` was cached in the process,
  the reference Engine builds an f32 tower and one step of the pixel slice
  holds at the parity tests' 1e-4.
- The fault itself, in a cache of this test's own: the cached bf16 tower
  comes back from ``get_clip_perceptor("TinyTest", dtype=jnp.float32)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.models import perceptor as j_perceptor
from pixray_tpu.models.perceptor import get_clip_perceptor
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import SLICE, _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401


def test_parity_holds_after_a_bf16_tower_was_cached(tmp_path, monkeypatch, request):
    monkeypatch.setattr(j_perceptor, "_perceptor_cache", {})  # the process's cache, as a JAX test leaves it
    cached = get_clip_perceptor("TinyTest", dtype=jnp.bfloat16)
    assert cached.model.dtype == jnp.bfloat16
    request.getfixturevalue("jax_perceptor_cache")

    cfg = dict(SLICE, iterations=1)
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path)), apply_side_effects=False))
    jp = ref.perceptors[0]
    assert jp is not cached and jp.model.dtype == jnp.float32
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path)), apply_side_effects=False), device="cpu",
                  state_dicts={"TinyTest": state_dict_from_flax(jp.variables["params"], jp.config)})
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    _, k_step = jax.random.split(ref.key)
    draws = _jax_step_draws(k_step, [32], cfg["num_cuts"], 96 / 54, cfg["batches"])
    ref.train(0)
    port.train(0, draws)
    np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)


def test_jax_cache_ignores_a_later_dtype(monkeypatch):
    monkeypatch.setattr(j_perceptor, "_perceptor_cache", {})
    first = get_clip_perceptor("TinyTest", dtype=jnp.bfloat16)
    again = get_clip_perceptor("TinyTest", dtype=jnp.float32)
    assert again is first and again.model.dtype == jnp.bfloat16
