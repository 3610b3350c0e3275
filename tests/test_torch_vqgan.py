"""The port's VQGAN model and drawer against ``pixray_tpu.models.vqgan`` and
``pixray_tpu.drawers.vqgan`` on the CPU, with the JAX weights carried
across by ``state_dict_from_flax_vqgan`` and inputs from a numpy seed.

Configs: ``tiny_test`` (attention only in the mid blocks) and the
``ATTN`` config of tests/test_heavy_drawers.py (attention inside the
down/up levels).  Tolerances: encoder/decoder outputs 1e-4 (f32 convs
summed in other orders), GroupNorm 2e-5 (flax's E[x²] − E[x]² variance
against torch's two-pass one), gradients 1e-4 of max|JAX gradient|.
Code indices are compared exactly on a codebook drawn wide (normal, std
0.5), after ``_assert_margin`` holds every vector's nearest code to win by
10× what the two sides' differences can move a distance gap: where the
margin is below f32 rounding, two correct implementations may pick
different codes.  Quantized vectors then agree to 1e-6: the straight-
through ``z + (z_q - z)`` rounds by the ulp of z, which the two sides
compute differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from pixray_tpu.drawers.vqgan import VqganDrawer as JVqganDrawer
from pixray_tpu.models import vqgan as J
from pixray_tpu_torch.drawers.vqgan import VqganDrawer
from pixray_tpu_torch.models import vqgan as P

ATTN = J.VQGANConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                     resolution=16, z_channels=32, embed_dim=32, n_embed=32)
CONFIGS = {"attn": ATTN, "tiny_test": J.VQGAN_CONFIGS["tiny_test"]}
ATOL = 1e-4


def _port_config(cfg):
    return P.VQGANConfig(**vars(cfg))


def _taming_weights(cfg, seed):
    """Seeded random weights as a taming-named numpy state dict (the
    port's initializer), with the codebook redrawn normal(0, 0.5)."""
    pm = P.init_random_(P.VQGAN(_port_config(cfg)), torch.Generator().manual_seed(seed))
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    sd["quantize.embedding.weight"] = (
        np.random.default_rng(seed).standard_normal((cfg.n_embed, cfg.embed_dim)).astype(np.float32) * 0.5)
    return sd


def _japply(jm, method):
    return jax.jit(lambda v, x: jm.apply(v, x, method=method))


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(JAX module, its variables, the port model holding the same weights:
    taming names → ``convert_taming_vqgan`` → the bridge)."""
    cfg = CONFIGS[request.param]
    jm = J.VQGAN(cfg)
    v = J.convert_taming_vqgan(_taming_weights(cfg, 0), cfg)
    pm = P.VQGAN(_port_config(cfg))
    P.load_taming_state_dict(pm, P.state_dict_from_flax_vqgan(v["params"], cfg))
    return jm, v, pm.eval()


def _nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_margin(flat, codebook, delta=0.0):
    """The nearest code of every row of ``flat`` beats the second by 10×
    the most that an input change of ``delta`` (L2, per row) and f32
    rounding of the distances can move the gap."""
    flat = np.asarray(flat, np.float64).reshape(-1, codebook.shape[1])
    d = ((flat[:, None, :] - np.asarray(codebook, np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    reach = 4 * delta * np.linalg.norm(codebook, axis=1).max() + 1e-6 * (d.max() + 1.0)
    assert (two[:, 1] - two[:, 0]).min() > 10 * reach


def _code_of(q, codebook):
    """The index of the code each quantized vector is (nearest, in f64)."""
    q = np.asarray(q, np.float64).reshape(-1, codebook.shape[1])
    return np.argmin(((q[:, None, :] - np.asarray(codebook, np.float64)[None]) ** 2).sum(-1), axis=1)


def _assert_same_codes(q_port, q_ref, codebook):
    np.testing.assert_array_equal(_code_of(q_port, codebook), _code_of(q_ref, codebook))
    np.testing.assert_allclose(q_port, q_ref, atol=1e-6)


def _latent(rng, v, shape, spread):
    """A continuous latent near the codebook (codes + noise of ``spread``)."""
    cb = np.asarray(v["params"]["codebook"])
    idx = rng.integers(0, cb.shape[0], shape[:-1])
    return (cb[idx] + spread * rng.standard_normal(shape)).astype(np.float32)


def test_config_table_matches_jax():
    assert {k: vars(c) for k, c in P.VQGAN_CONFIGS.items()} == {k: vars(c) for k, c in J.VQGAN_CONFIGS.items()}


def test_encode_decode_match_jax(pair):
    jm, v, pm = pair
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32)
    pre_j = np.asarray(_japply(jm, lambda m, x: m.quant_conv(m.encoder(x)))(v, x))
    with torch.no_grad():
        pre_p = _nhwc(pm.quant_conv(pm.encoder(_nchw(x))))
    np.testing.assert_allclose(pre_p, pre_j, atol=ATOL)
    _assert_margin(pre_j, np.asarray(v["params"]["codebook"]), np.linalg.norm(pre_p - pre_j, axis=-1).max())
    zq_j = np.asarray(_japply(jm, jm.encode)(v, x))
    with torch.no_grad():
        zq_p = _nhwc(pm.encode(_nchw(x)))
    _assert_same_codes(zq_p, zq_j, np.asarray(v["params"]["codebook"]))

    y_j = np.asarray(_japply(jm, jm.decode)(v, zq_j))
    with torch.no_grad():
        y_p = _nhwc(pm.decode(_nchw(zq_j)))
    assert y_p.shape == y_j.shape == x.shape
    np.testing.assert_allclose(y_p, y_j, atol=ATOL)


def test_quantize_and_decode_from_continuous_match_jax(pair):
    jm, v, pm = pair
    rng = np.random.default_rng(1)
    z = _latent(rng, v, (1, 4, 6, 32), 0.05)
    cb = np.asarray(v["params"]["codebook"])
    _assert_margin(z, cb)
    q_j = np.asarray(_japply(jm, jm.quantize)(v, z))
    with torch.no_grad():
        q_p = _nhwc(pm.quantize(_nchw(z)))
        idx = pm.quantize.nearest(torch.tensor(z.reshape(-1, 32))).numpy()
    _assert_same_codes(q_p, q_j, cb)
    np.testing.assert_array_equal(idx, _code_of(q_j, cb))
    y_j = np.asarray(_japply(jm, jm.decode_from_continuous)(v, z))
    with torch.no_grad():
        y_p = _nhwc(pm.decode_from_continuous(_nchw(z)))
    np.testing.assert_allclose(y_p, y_j, atol=ATOL)


def test_quantize_first_index_on_ties():
    pm = P.VQGAN(_port_config(ATTN))
    with torch.no_grad():
        pm.quantize.codebook.zero_()
        pm.quantize.codebook[5] = 1.0
    z = torch.zeros((3, 32))
    assert pm.quantize.nearest(z).tolist() == [0, 0, 0]  # all of 0..31 but 5 tie
    assert np.asarray(jnp.argmin(jnp.zeros((3, 4)), axis=1)).tolist() == [0, 0, 0]


def test_straight_through_gradient_matches_jax(pair):
    jm, v, pm = pair
    rng = np.random.default_rng(2)
    z = _latent(rng, v, (1, 4, 6, 32), 0.05)
    _assert_margin(z, np.asarray(v["params"]["codebook"]))
    g_j = np.asarray(jax.jit(jax.grad(lambda z: jnp.sum(jm.apply(v, z, method=jm.decode_from_continuous) ** 2)))(
        jnp.asarray(z)))
    zt = _nchw(z).requires_grad_(True)
    (g_p,) = torch.autograd.grad(torch.sum(pm.decode_from_continuous(zt) ** 2), zt)
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(_nhwc(g_p) / scale, g_j / scale, atol=1e-4)


def test_upsample_is_jax_nearest_resize():
    x = np.random.default_rng(3).standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="nearest"))
    out = _nhwc(torch.nn.functional.interpolate(_nchw(x), scale_factor=2.0, mode="nearest"))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_downsample_pads_bottom_right(hw):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, *hw, 32)).astype(np.float32)
    jd = J.Downsample()
    v = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jd.apply(v, jnp.asarray(x)))
    pd = P.Downsample(32)
    sd = P.state_dict_from_flax_vqgan({"d": v["params"]}, ATTN)
    pd.load_state_dict({k.removeprefix("d."): torch.tensor(a) for k, a in sd.items()})
    with torch.no_grad():
        out = _nhwc(pd(_nchw(x)))
    assert out.shape == ref.shape == (1, (hw[0] + 1 - 3) // 2 + 1, (hw[1] + 1 - 3) // 2 + 1, 32)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_groupnorm_and_swish_match_flax():
    import flax.linen as nn

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 6, 5, 64)) * 3 + 1.5).astype(np.float32)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-6)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    pg = P.GroupNorm(64)
    with torch.no_grad():
        pg.weight.copy_(torch.tensor(scale))
        pg.bias.copy_(torch.tensor(bias))
        out = _nhwc(pg(_nchw(x)))
        sw = P.swish(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(sw, np.asarray(J.swish(jnp.asarray(x))), atol=1e-6)


def _taming_state_dict(cfg, rng):
    """A taming-style state dict of ATTN's shapes (as tests/test_heavy_drawers.py builds it)."""
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal((o,)).astype(np.float32)

    def gn(name, c):
        sd[f"{name}.weight"] = rng.standard_normal((c,)).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal((c,)).astype(np.float32)

    def res(prefix, i, o):
        gn(f"{prefix}.norm1", i)
        conv(f"{prefix}.conv1", o, i, 3)
        gn(f"{prefix}.norm2", o)
        conv(f"{prefix}.conv2", o, o, 3)
        if i != o:
            conv(f"{prefix}.nin_shortcut", o, i, 1)

    def attn(prefix, c):
        gn(f"{prefix}.norm", c)
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{prefix}.{n}", c, c, 1)

    ch = cfg.ch
    conv("encoder.conv_in", ch, 3, 3)
    res("encoder.down.0.block.0", ch, ch)
    conv("encoder.down.0.downsample.conv", ch, ch, 3)
    res("encoder.down.1.block.0", ch, ch * 2)
    attn("encoder.down.1.attn.0", ch * 2)
    res("encoder.mid.block_1", ch * 2, ch * 2)
    attn("encoder.mid.attn_1", ch * 2)
    res("encoder.mid.block_2", ch * 2, ch * 2)
    gn("encoder.norm_out", ch * 2)
    conv("encoder.conv_out", cfg.z_channels, ch * 2, 3)
    conv("decoder.conv_in", ch * 2, cfg.z_channels, 3)
    res("decoder.mid.block_1", ch * 2, ch * 2)
    attn("decoder.mid.attn_1", ch * 2)
    res("decoder.mid.block_2", ch * 2, ch * 2)
    res("decoder.up.1.block.0", ch * 2, ch * 2)
    res("decoder.up.1.block.1", ch * 2, ch * 2)
    attn("decoder.up.1.attn.0", ch * 2)
    attn("decoder.up.1.attn.1", ch * 2)
    conv("decoder.up.1.upsample.conv", ch * 2, ch * 2, 3)
    res("decoder.up.0.block.0", ch * 2, ch)
    res("decoder.up.0.block.1", ch, ch)
    gn("decoder.norm_out", ch)
    conv("decoder.conv_out", 3, ch, 3)
    conv("quant_conv", cfg.embed_dim, cfg.z_channels, 1)
    conv("post_quant_conv", cfg.z_channels, cfg.embed_dim, 1)
    sd["quantize.embedding.weight"] = rng.standard_normal((cfg.n_embed, cfg.embed_dim)).astype(np.float32)
    return sd


def test_bridge_inverts_convert_taming_vqgan():
    sd = _taming_state_dict(ATTN, np.random.default_rng(6))
    back = P.state_dict_from_flax_vqgan(J.convert_taming_vqgan(sd, ATTN)["params"], ATTN)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    pm = P.VQGAN(_port_config(ATTN))
    assert sorted(pm.state_dict()) == sorted(sd)


@pytest.fixture(scope="module")
def drawers(tmp_path_factory):
    """The JAX and port tiny_test drawers, both loaded through
    ``--vqgan_checkpoint`` from one taming-style ``{"state_dict": ...}``
    file that also holds a key neither model has (taming's loss weights)."""
    sd = {k: torch.tensor(a) for k, a in _taming_weights(J.VQGAN_CONFIGS["tiny_test"], 1).items()}
    sd["loss.discriminator.main.0.weight"] = torch.zeros(4, 3, 4, 4)
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    torch.save({"state_dict": sd, "global_step": 7}, path)
    settings = SimpleNamespace(size=[49, 33], vqgan_model="tiny_test", vqgan_checkpoint=str(path))
    jd, pd = JVqganDrawer(settings), VqganDrawer(settings)
    jd.load_model(settings)
    pd.load_model(settings, "cpu")
    return jd, pd


def test_checkpoint_file_loads_alike_in_both_packages(drawers):
    jd, pd = drawers
    assert set(pd.model.state_dict()) == set(P.state_dict_from_flax_vqgan(jd.model_params["params"], jd.config))
    for k, t in pd.model.state_dict().items():
        ref = P.state_dict_from_flax_vqgan(jd.model_params["params"], jd.config)[k]
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
    z = _latent(np.random.default_rng(7), jd.model_params, (16, 24, 32), 0.05)
    _assert_margin(z, np.asarray(jd.model_params["params"]["codebook"]))
    ref = np.asarray(jd.synth(jd.model_params, jnp.asarray(z), 0))
    with torch.no_grad():
        out = pd.synth(pd.model_params, torch.tensor(z)).numpy()
    assert out.shape == ref.shape == (32, 48, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_drawer_snap_canvas():
    for name, size, want in (("tiny_test", [49, 33], (48, 32)), ("imagenet_f16_16384", [384, 216], (384, 208))):
        settings = SimpleNamespace(size=size, vqgan_model=name, vqgan_checkpoint=None)
        jd, pd = JVqganDrawer(settings), VqganDrawer(settings)
        jd.config = pd.config = P.VQGAN_CONFIGS[name]
        assert pd.snap_canvas(size) == jd.snap_canvas(size) == want


def test_drawer_latents_clamp_and_synth_match_jax(drawers):
    jd, pd = drawers
    assert pd.snap_canvas([49, 33]) == jd.snap_canvas([49, 33]) == (48, 32)
    cb = np.asarray(jd.model_params["params"]["codebook"])
    key = jax.random.PRNGKey(9)
    z_j = np.asarray(jd.init_params(key))
    idx = np.array(jax.random.randint(key, (16 * 24,), 0, cb.shape[0]))
    z_p = pd.init_params(None, indices=idx)
    assert z_p.shape == z_j.shape == (16, 24, 32)
    np.testing.assert_array_equal(z_p.numpy(), z_j)
    assert pd.init_params(torch.Generator().manual_seed(0)).shape == (16, 24, 32)

    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    enc_j = np.asarray(jd.params_from_image(jnp.asarray(img)))
    pre_j = np.asarray(jd.model.apply(jd.model_params, jnp.asarray(img)[None],
                                      method=lambda m, x: m.quant_conv(m.encoder(x))))
    with torch.no_grad():
        pre_p = _nhwc(pd.model.quant_conv(pd.model.encoder(_nchw(img[None]))))
    _assert_margin(pre_j, cb, np.linalg.norm(pre_p - pre_j, axis=-1).max())
    _assert_same_codes(pd.params_from_image(torch.tensor(img)).numpy(), enc_j, cb)
    _assert_same_codes(pd.init_params(None, torch.tensor(img)).numpy(), enc_j, cb)

    z = (cb.min(0) + rng.uniform(-0.5, 1.5, (16, 24, 32)) * (cb.max(0) - cb.min(0))).astype(np.float32)
    np.testing.assert_array_equal(pd.clip_params(torch.tensor(z)).numpy(), np.asarray(jd.clip_params(jnp.asarray(z))))

    z = _latent(rng, jd.model_params, (16, 24, 32), 0.05)
    _assert_margin(z, cb)
    ref = np.asarray(jd.synth(jd.model_params, jnp.asarray(z), 0))
    with torch.no_grad():
        out = pd.synth(pd.model_params, torch.tensor(z)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("name", ["imagenet_f16_16384", "openimages_f16_8192"])
def test_full_width_shapes_match_jax(name):
    """Every key and shape of the JAX model's parameters at full width,
    bridged, equals the port's module built on the meta device."""
    cfg = J.VQGAN_CONFIGS[name]
    shapes = jax.eval_shape(J.VQGAN(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    placeholders = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    bridged = {k: a.shape for k, a in P.state_dict_from_flax_vqgan(placeholders, cfg).items()}
    with torch.device("meta"):
        pm = P.VQGAN(P.VQGAN_CONFIGS[name])
    assert {k: tuple(t.shape) for k, t in pm.state_dict().items()} == bridged
    assert ("quantize.embed.weight" in bridged) == cfg.gumbel
    assert "decoder.up.4.attn.2.q.weight" in bridged and "encoder.down.4.attn.1.q.weight" in bridged
