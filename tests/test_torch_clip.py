"""Port CLIP against the JAX package: tokenizer ids, config tables, the weight
bridge, and the TinyTest towers in float32 (same weights through the bridge).

Tolerances: towers 1e-4 absolute on embeddings of unit scale (f32 matmuls
and attention softmax summed in another order; JAX's fused attention path
against plain matmul + softmax), 1e-4 on the image gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.models.clip import configs as JCFG
from pixray_tpu.models.clip.convert import convert_openai_clip
from pixray_tpu.models.clip.tokenizer import tokenize as j_tokenize
from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu_torch.models.clip import configs as CFG
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.clip.tokenizer import tokenize
from pixray_tpu_torch.models.perceptor import Perceptor

TEXTS = ["sunrise", "A Watercolor of a LIGHTHOUSE, at night!", "über café 42 ☀", ""]


@pytest.fixture(scope="module")
def jax_tiny():
    return JPerceptor("TinyTest", dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    sd = state_dict_from_flax(jax_tiny.variables["params"], jax_tiny.config)
    return Perceptor("TinyTest", "cpu", torch.float32, state_dict=sd)


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_equal(text):
    np.testing.assert_array_equal(tokenize(text), j_tokenize(text))


def test_config_tables_equal():
    for port_table, jax_table in ((CFG.CLIP_CONFIGS, JCFG.CLIP_CONFIGS), (CFG.SLIP_CONFIGS, JCFG.SLIP_CONFIGS)):
        assert port_table.keys() == jax_table.keys()
        for name in port_table:
            assert dataclasses.asdict(port_table[name]) == dataclasses.asdict(jax_table[name])
    for attr in ("CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(CFG, attr) == getattr(JCFG, attr)


def test_bridge_round_trip(jax_tiny):
    """flax params → OpenAI state dict → convert_openai_clip gives back the same tree."""
    params = jax_tiny.variables["params"]
    sd = state_dict_from_flax(params, jax_tiny.config)
    back = convert_openai_clip(sd, jax_tiny.config)["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_state_dict_keys_are_the_models(port_tiny, jax_tiny):
    sd = state_dict_from_flax(jax_tiny.variables["params"], jax_tiny.config)
    assert set(sd) == set(port_tiny.model.state_dict())


def test_text_tower_matches(jax_tiny, port_tiny):
    ref = np.asarray(jax_tiny.encode_text(TEXTS[:3]))
    np.testing.assert_allclose(port_tiny.encode_text(TEXTS[:3]).numpy(), ref, atol=1e-4)
    ref_s = np.asarray(jax_tiny.encode_text_with_stops("sunrise"))
    np.testing.assert_allclose(port_tiny.encode_text_with_stops("sunrise").numpy(), ref_s, atol=1e-4)


def test_vision_tower_matches_with_grad(jax_tiny, port_tiny):
    """Channel-major cutouts with the preprocessing affine folded in, as the
    engine calls it; forward and the gradient w.r.t. the cutouts."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-0.1, 1.1, (5, 3, 32, 32)).astype(np.float32)
    cot = rng.standard_normal((5, 32)).astype(np.float32)

    def jf(x):
        return jax_tiny.image_fn(jax_tiny.variables, x, data_format="NCHW")

    ref, vjp = jax.vjp(jf, jnp.asarray(imgs))
    (ref_g,) = vjp(jnp.asarray(cot))
    x = torch.tensor(imgs, requires_grad=True)
    out = port_tiny.image_fn(x)
    (g,) = torch.autograd.grad(out, x, torch.tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-4)


def test_random_init_is_seeded_and_named():
    a = Perceptor("TinyTest", "cpu")
    b = Perceptor("TinyTest", "cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.model.visual.transformer.resblocks[0].mlp.c_fc.weight
    assert abs(float(w.std()) - 64 ** -0.5) < 0.02  # lecun_normal: std sqrt(1/fan_in)
