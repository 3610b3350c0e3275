"""The ResMem loss in the port against the JAX package.

- The prediction (AlexNet features with XLA's "SAME" padding written out,
  the head, the sigmoid) within 1e-5, the loss within 1e-5 and the
  gradient to the cutouts within 1e-4 (of its largest element), with the
  JAX params carried across by the bridge; cutouts outside [0, 1] (the
  clip) at the 224-px size and at a 32-px size (the smallest size scores
  when there is no 224; held in float64, see the test).
- ``same_padding`` against XLA's own on every layer's shape.
- A ``resmem_model.pt`` file written by the test, in torchvision's AlexNet
  layout (sorted keys map only the first convolution) and in a layout
  whose sorted keys map all five: the port maps what the JAX package maps.
- The slice: a hex pixel run with ``resmem`` against the JAX engine (the
  one engine slice of these losses and geometries).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.losses import resmem as JR
from pixray_tpu_torch.losses import resmem as PR
from torch_parity import jax_perceptor_cache  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    ref = JR.ResmemLoss(SimpleNamespace())
    port = PR.ResmemLoss(SimpleNamespace())
    port.place("cpu", torch.float32, PR.state_dict_from_flax_resmem(ref.params))
    return ref, port


@pytest.mark.parametrize("size,dtype", [(224, np.float32), (32, np.float64)], ids=["224-f32", "32-f64"])
def test_prediction_loss_and_gradient_match_jax(pair, size, dtype):
    """At 32 px the 8x upsampling leaves near-equal values in some 3x3 pool
    windows: one of them picks another maximum in float32 than in float64
    in the port (the gradient then parts by 1.1e-3 of its norm from
    float64's), a tie, not a fault; that size is held in float64 in both."""
    ref, port = pair
    args = SimpleNamespace(resmem_weight=1.5)
    x = np.random.default_rng(size).uniform(-0.1, 1.1, (3, size, size, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), ref.params)
        want = np.asarray(ref._predict(jnp.clip(jnp.asarray(x), 0.0, 1.0), params))
        jval, jg = jax.value_and_grad(lambda c: ref.get_loss({size: c}, None, args, params=params))(jnp.asarray(x))
    if dtype == np.float64:
        port = PR.ResmemLoss(SimpleNamespace())
        port.place("cpu", torch.float64, PR.state_dict_from_flax_resmem(ref.params))
        port.model.mean, port.model.std = port.model.mean.double(), port.model.std.double()
    got = port.model(torch.tensor(x).clamp(0, 1))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    xt = torch.tensor(x, requires_grad=True)
    val = port.get_loss({size: xt}, None, args)
    (g,) = torch.autograd.grad(val, xt)
    np.testing.assert_allclose(float(val), float(jval), atol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * np.abs(jg).max())


def test_same_padding_matches_xla():
    size = 227
    for out_ch, k, s, pool in JR.ALEXNET_SPEC:
        pads = jax.lax.padtype_to_pads((size, size), (k, k), (s, s), "SAME")
        assert [PR.same_padding(size, k, s)] * 2 == [tuple(p) for p in pads]
        size = -(-size // s)
        if pool:
            size = (size - 3) // 2 + 1
    assert size == 6


@pytest.mark.parametrize("layout", ["torchvision", "ordered"])
def test_resmem_file_maps_like_jax(tmp_path, monkeypatch, capsys, layout):
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    gen = torch.Generator().manual_seed(3)
    keys = [0, 3, 6, 8, 10] if layout == "torchvision" else ["a", "b", "c", "d", "e"]
    sd, in_ch = {}, 3
    for key, (out_ch, k, _s, _p) in zip(keys, JR.ALEXNET_SPEC):
        sd[f"alexnet.features.{key}.weight"] = torch.randn((out_ch, in_ch, k, k), generator=gen) * 0.05
        sd[f"alexnet.features.{key}.bias"] = torch.randn((out_ch,), generator=gen) * 0.05
        in_ch = out_ch
    sd["fc.weight"] = torch.zeros((1, 4))
    torch.save(sd, tmp_path / "resmem_model.pt")

    ref = JR.ResmemLoss(SimpleNamespace())
    jax_line = [line for line in capsys.readouterr().out.splitlines() if line.startswith("ResMem: mapped")]
    # the port's mapping over the JAX package's random start
    model = PR.ResMem()
    unmapped = JR.ResmemLoss.__new__(JR.ResmemLoss)
    key1, key2 = jax.random.split(jax.random.PRNGKey(227))
    unmapped.params = {"alex": JR.init_alexnet_params(key1), "head": JR.init_head_params(key2, 6 * 6 * 256)}
    model.load_state_dict(PR.state_dict_from_flax_resmem(unmapped.params))
    loaded = PR.map_resmem_file(model, torch.load(tmp_path / "resmem_model.pt"))
    assert jax_line == [f"ResMem: mapped {loaded} conv layers from {tmp_path / 'resmem_model.pt'}"]
    assert loaded == (1 if layout == "torchvision" else 5)
    want = PR.state_dict_from_flax_resmem(ref.params)
    for name, value in model.state_dict().items():
        if name in want:
            assert torch.equal(value, want[name]), name
    # the loss finds the file by itself and says so
    port = PR.ResmemLoss(SimpleNamespace())
    port.place("cpu", torch.float32)
    assert f"ResMem: mapped {loaded} conv layers" in capsys.readouterr().out
    assert torch.equal(port.model.convs[0].weight, sd[f"alexnet.features.{keys[0]}.weight"])


# ------------------------------------------------------------------ the slice against the JAX engine
def test_hex_resmem_slice_matches_jax_engine(tmp_path, monkeypatch, jax_perceptor_cache):
    """``--drawer pixel --pixel_type hex --custom_loss resmem:3,saturation``
    under TinyTest at 48x36, 3 steps, the port fed the JAX engine's draws:
    per-step losses within 1e-4 and the latent within 1e-3, as the other
    slices hold them; the term names equal.  ``style`` is held at loss
    level (tests/test_torch_style.py): inside the JAX step its compile
    alone took ~45 s on the CPU (the same slice with ``style:300`` passed
    at 77 s)."""
    from pixray_tpu.config import apply_settings as j_apply_settings
    from pixray_tpu.engine.core import Engine as JEngine
    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
    from test_torch_plugins_slice import BASE, jax_step_draws

    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    cfg = dict(BASE, size=[48, 36], drawer="pixel", pixel_type="hex", pixel_size=[9, 7], clip_models="TinyTest",
               custom_loss="resmem:3,saturation")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    weights = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    weights["resmem"] = PR.state_dict_from_flax_resmem(ref.custom_losses[0][0].params)
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    assert "coverage_indices" in port.drawer_params
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))
    h, w = port.side_y, port.side_x
    for it in range(cfg["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = jax_step_draws(k_step, [32], cfg["num_cuts"], w / h, 1, [], (h, w))
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        np.testing.assert_allclose(port.z.numpy(), np.asarray(ref.z), atol=1e-3)
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0", "loss:ResmemLoss", "loss:SaturationLoss:0"]
