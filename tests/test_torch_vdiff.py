"""The v-diffusion models of the port against the JAX package on the CPU.

- the schedules (default and log, ``--vdiff_skip`` 0 and 50) the drawers
  build, within 1e-6;
- ``sample_step`` / ``sample_noise`` fed the JAX normal draw, at the first
  entry, inside, and at the last, where ``alphas[i + 1]`` is one past the
  end (JAX clamps the gather; the port must too);
- the upstream executor against ``VDiffUpstream.apply`` for ``tiny_up`` and
  ``tiny_up_mod`` (with and without a clip embedding) through the bridge,
  and the compact ``VDiffUNet`` (``tiny_test``), within 1e-4; the ``up``
  op's bilinear and the compact net's nearest resize against
  ``jax.image.resize``, edges included;
- every published spec: the port's copy, its shape signature and
  parameter total equal to the JAX package's, the module built on the
  meta device (nothing allocated) holding exactly those keys and shapes;
- a state dict written to ``<tmp>/<name>.pth`` loads through
  ``$PIXRAY_TPU_MODELS``; a wrong shape or a missing key raises naming it;
- the drawer under both schedules (the default, and log with
  ``--vdiff_skip 50``): the canvas at every entry and its gradient,
  ``post_step``'s learning rate (1e-5 relative: the schedules' arccos may
  round one ulp otherwise) and re-noised latent, ``None`` at step 0; the
  init draw and its blend with an init image; the clip embedding's width
  check.  Both drawers read the UNet's weights from one ``.pth``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.drawers.vdiff import VdiffDrawer as JVdiffDrawer
from pixray_tpu.models import vdiff as JV
from pixray_tpu.models import vdiff_upstream as JU
from pixray_tpu_torch.drawers.vdiff import VdiffDrawer, build_vdiff_model
from pixray_tpu_torch.models import vdiff as PV
from pixray_tpu_torch.models import vdiff_upstream as PU


def _settings(**kw):
    base = dict(size=[48, 32], vdiff_model="tiny_up", vdiff_schedule="default", vdiff_skip=0, iterations=6,
                clip_models=["TinyTest"], transparent=False)
    return SimpleNamespace(**{**base, **kw})


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """``tiny_up.pth`` (seeded) where both packages look for it: the JAX
    package's random init compiles a draw per parameter shape (~17 s)."""
    path = tmp_path_factory.mktemp("models")
    with torch.device("meta"):
        model = PU.VDiffUpstream(PU.UPSTREAM_SPECS["tiny_up"])
    torch.save(PU.init_random_(model.to_empty(device="cpu"), torch.Generator().manual_seed(3)).state_dict(),
               path / "tiny_up.pth")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIXRAY_TPU_MODELS", str(path))
        yield path


def _drawers(**kw):
    """The JAX and the port's drawer for ``tiny_up``, each loading the same ``.pth``."""
    settings = _settings(**kw)
    ref = JVdiffDrawer(settings)
    ref.load_model(settings)
    port = VdiffDrawer(settings)
    port.load_model(settings, "cpu", torch.float32)
    return ref, port


@pytest.mark.parametrize("schedule,skip", [("default", 0), ("default", 50), ("log", 0), ("log", 50)])
def test_schedules_match_jax(models_dir, schedule, skip):
    ref, port = _drawers(vdiff_schedule=schedule, vdiff_skip=skip, iterations=40)
    for name in ("steps", "alphas", "sigmas"):
        want = np.asarray(getattr(ref.sample_state, name))
        got = getattr(port.sample_state, name).numpy()
        assert got.shape == want.shape == (41,)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_array_equal(port.alphas_host, port.sample_state.alphas.numpy())
    np.testing.assert_array_equal(port.sigmas_host, port.sample_state.sigmas.numpy())


def _fake_v(x):
    return 0.3 * x + 0.1 * x**2 - 0.05


@pytest.mark.parametrize("i", [0, 3, 6])
def test_sampler_matches_jax_with_its_noise(i):
    """The iteration count is 6: the schedule has 7 entries, and i = 6 reads
    alphas[7], which JAX clamps to the last entry."""
    steps = JV.get_spliced_ddpm_cosine_schedule(jnp.linspace(1.0, 0.0, 8)[:-1])
    jstate = JV.sample_setup(lambda x, t, extra: _fake_v(x), steps, 1.0, {})
    pstate = PV.sample_setup(torch.tensor(np.asarray(steps)), 1.0)
    x = np.random.default_rng(i).standard_normal((1, 8, 12, 3)).astype(np.float32)
    noise = jax.random.normal(jax.random.PRNGKey(i), x.shape, jnp.float32)
    jpred, jv = JV.sample_step(jstate, jnp.asarray(x), i)
    want = JV.sample_noise(jstate, jnp.asarray(x), i, jpred, jv, jax.random.PRNGKey(i))
    xt = torch.tensor(x)
    for index in (i, torch.tensor(i, dtype=torch.int32)):  # a host int and a () tensor, as the step passes it
        pred, v = PV.sample_step(pstate, xt, index, lambda x, t: _fake_v(x))
        got = PV.sample_noise(pstate, xt, index, pred, v, torch.tensor(np.asarray(noise)))
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_at_clamps_like_a_jax_gather():
    table = torch.arange(5, dtype=torch.float32)
    assert [float(PV.at(table, i)) for i in (0, 4, 5, 9)] == [0.0, 4.0, 4.0, 4.0]
    assert float(PV.at(table, torch.tensor(7, dtype=torch.int32))) == 4.0
    assert float(np.asarray(jnp.arange(5.0)[jnp.asarray(7)])) == 4.0


def _executor_inputs(spec, seed, b=2, h=16, w=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (b,)).astype(np.float32)
    ce = None if spec.clip_embed_dim is None else rng.standard_normal((b, spec.clip_embed_dim)).astype(np.float32)
    return x, t, ce


@pytest.mark.parametrize("name,with_embed", [("tiny_up", False), ("tiny_up_mod", False), ("tiny_up_mod", True)])
def test_executor_matches_jax(name, with_embed):
    spec = JU.UPSTREAM_SPECS[name]
    params = JU.init_params(spec, jax.random.PRNGKey(3))
    # non-trivial biases and norm affines, so their layouts are tested too
    rng = np.random.default_rng(4)
    params = {k: (rng.normal(0.0, 0.2, v.shape).astype(np.float32) + (1.0 if k.endswith("norm.weight") else 0.0)
                  if v.ndim == 1 else np.asarray(v)) for k, v in params.items()}
    x, t, ce = _executor_inputs(spec, 5)
    ce = ce if with_embed else None
    want = np.asarray(JU.VDiffUpstream(spec).apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                                                   jnp.asarray(t), None if ce is None else jnp.asarray(ce)))
    model, _, _, _ = build_vdiff_model(name, "cpu", PU.state_dict_from_vdiff_params(params, PU.UPSTREAM_SPECS[name]))
    with torch.no_grad():
        got = model(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(t), None if ce is None else torch.tensor(ce))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


def test_compact_unet_matches_jax():
    cfg = JV.VDIFF_CONFIGS["tiny_test"]
    model = JV.VDiffUNet(cfg)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)), None)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda v: rng.normal(0.0, 0.2, v.shape).astype(np.float32) + (v == 1).astype(np.float32)
        if v.ndim == 1 else np.asarray(v), variables["params"])
    x = rng.standard_normal((1, 16, 24, 3)).astype(np.float32)
    t = np.asarray([0.37], np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), None))
    port, _, _, _ = build_vdiff_model("tiny_test", "cpu", PV.state_dict_from_flax_vdiff_unet(params, cfg))
    with torch.no_grad():
        got = port(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(t))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("method,mode", [("bilinear", "bilinear"), ("nearest", "nearest")])
def test_upsampling_matches_jax_image_resize(method, mode):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method))
    kw = {"align_corners": False} if mode == "bilinear" else {}
    got = torch.nn.functional.interpolate(torch.tensor(x).permute(0, 3, 1, 2), scale_factor=2, mode=mode, **kw)
    got = got.permute(0, 2, 3, 1).numpy()
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(JU.UPSTREAM_SPECS))
def test_specs_and_signatures_match_jax(name):
    spec, ref = PU.UPSTREAM_SPECS[name], JU.UPSTREAM_SPECS[name]
    assert vars(spec) == vars(ref)
    shapes = PU.expected_state_shapes(spec)
    assert shapes == JU.expected_state_shapes(ref)
    total = sum(int(np.prod(s)) for s in shapes.values())
    if name in PU.PUBLISHED_PARAM_COUNTS_M:
        assert PU.PUBLISHED_PARAM_COUNTS_M == JU.PUBLISHED_PARAM_COUNTS_M
        assert abs(total / 1e6 - PU.PUBLISHED_PARAM_COUNTS_M[name]) / PU.PUBLISHED_PARAM_COUNTS_M[name] < 0.01
    with torch.device("meta"):
        model = PU.VDiffUpstream(spec)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert sum(p.numel() for p in model.parameters()) == total


def test_compact_configs_match_jax():
    assert {k: vars(v) for k, v in PV.VDIFF_CONFIGS.items()} == {k: vars(v) for k, v in JV.VDIFF_CONFIGS.items()}
    assert PV.VDIFF_CHECKPOINT_URLS == JV.VDIFF_CHECKPOINT_URLS


def test_checkpoint_found_on_disk_and_checked(tmp_path, monkeypatch):
    spec = PU.UPSTREAM_SPECS["tiny_up"]
    sd = PU.state_dict_from_vdiff_params(JU.init_params(spec, jax.random.PRNGKey(9)), spec)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, tmp_path / "tiny_up.pth")
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    model, _, _, source = build_vdiff_model("tiny_up", "cpu")
    assert source == str(tmp_path / "tiny_up.pth")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    key = "net.3.main.1.main.2.weight"
    bad = dict(sd, **{key: np.zeros((3, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        build_vdiff_model("tiny_up", "cpu", bad)
    missing = {k: v for k, v in sd.items() if k != "timestep_embed.weight"}
    with pytest.raises(KeyError, match="timestep_embed.weight"):
        build_vdiff_model("tiny_up", "cpu", missing)


@pytest.mark.parametrize("schedule,skip", [("default", 0), ("log", 50)])
def test_synth_and_post_step_match_jax(models_dir, schedule, skip):
    """The canvas at every schedule entry (a host int and the step's () int32
    tensor) and its input gradient, then ``post_step``: None at step 0, the
    learning rate and the re-noised latent given the JAX draw, up to the
    last step, whose re-noise reads alphas[iterations + 1]."""
    ref, port = _drawers(iterations=4, vdiff_schedule=schedule, vdiff_skip=skip)
    z = np.random.default_rng(0).standard_normal((1, 128, 128, 3)).astype(np.float32)
    g = np.random.default_rng(1).standard_normal((32, 48, 3)).astype(np.float32)
    for it in range(5):
        want, vjp = jax.vjp(lambda x: ref.synth(ref.model_params, x, it), jnp.asarray(z))
        zt = torch.tensor(z).requires_grad_(True)
        got = port.synth(port.model_params, zt, torch.tensor(it, dtype=torch.int32))
        (got * torch.tensor(g)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
        np.testing.assert_allclose(zt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(port.synth(port.model_params, torch.tensor(z), it).detach().numpy(),
                                      got.detach().numpy())
    assert port.post_step(torch.tensor(z), 0, torch.zeros(z.shape)) is None and ref.post_step(jnp.asarray(z), 0) is None
    for it in (1, 3, 4):  # 4 = iterations: alphas[5] is past the end
        noise = jax.random.normal(jax.random.PRNGKey(it), z.shape)
        want = np.asarray(ref.post_step(jnp.asarray(z), it))
        got = port.post_step(torch.tensor(z), it, torch.tensor(np.asarray(noise)))
        assert port.learning_rate == pytest.approx(ref.learning_rate, rel=1e-5, abs=0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_clip_embed_width_is_checked():
    settings = _settings(vdiff_model="tiny_up_mod")
    port = VdiffDrawer(settings)
    port.load_model(settings, "cpu")
    with pytest.raises(ValueError, match="12-wide"):
        port.set_clip_embed(np.ones((1, 32), np.float32))
    port.set_clip_embed(np.ones((1, 12), np.float32))
    assert port.model_params["clip_embed"].shape == (1, 12)


def test_init_params_match_jax(models_dir):
    """The normal draw passed in (the JAX drawer's own), alone and blended
    with an init image centred on the generated canvas at alphas[0] /
    sigmas[0]."""
    ref, port = _drawers(size=[48, 32], vdiff_skip=30)
    key = jax.random.PRNGKey(4)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (1, 128, 128, 3))))
    image = np.random.default_rng(0).uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    for init in (None, image):
        want = np.asarray(ref.init_params(key, None if init is None else jnp.asarray(init)))
        got = port.init_params(None, None if init is None else torch.tensor(init), noise=noise)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
