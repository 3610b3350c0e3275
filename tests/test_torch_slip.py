"""The port's timm (SLIP-style) ViT trunk against the JAX package's, on the
CPU in float32, with the same weights carried across by the bridge: the
patch conv's bias added after the preprocessing fold's, no ``ln_pre``,
exact erf GELU in the vision MLPs (QuickGELU in the text tower), the
ImageNet statistics.  The tower is a 48 px trunk with 16 px patches (3x3
tokens and the class token).

Tolerances: 1e-4 absolute on embeddings of unit scale and 1e-4 on the
image gradient, as the OpenAI ViT's (tests/test_torch_clip.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixray_tpu.models.clip.convert import convert_slip_clip
from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.clip.configs import IMAGENET_MEAN, IMAGENET_STD
from pixray_tpu_torch.models.clip.model import quick_gelu
from pixray_tpu_torch.models.perceptor import Perceptor
from torch_parity import tiny_towers  # noqa: F401

pytestmark = pytest.mark.usefixtures("tiny_towers")

ATOL = 1e-4


@pytest.fixture(scope="module")
def timm(tiny_towers):
    jp = JPerceptor("TinyTimm48", dtype=jnp.float32)
    rng = np.random.default_rng(0)
    # a non-zero patch bias and LayerNorm affines, so that their placement shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * 0.2 + (getattr(path[-1], "key", "") == "scale")).astype(
            np.float32) if getattr(path[-1], "key", "") in ("patch_bias", "scale", "bias") else np.asarray(a),
        jp.variables["params"])
    port = Perceptor("TinyTimm48", "cpu", torch.float32, state_dict=state_dict_from_flax(params, jp.config))
    return jp, {"params": params}, port


def test_image_fn_and_its_input_gradient_match(timm):
    jp, variables, port = timm
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-0.1, 1.1, (4, 3, 48, 48)).astype(np.float32)
    cot = rng.standard_normal((4, 32)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda x: jp.image_fn(variables, x, data_format="NCHW")), jnp.asarray(imgs))
    (ref_g,) = vjp(jnp.asarray(cot))
    x = torch.tensor(imgs, requires_grad=True)
    out = port.image_fn(x)
    (g,) = torch.autograd.grad(out, x, torch.tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=ATOL)


def test_text_tower_matches(timm):
    jp, variables, port = timm
    ref = jp.model.apply(variables, jnp.asarray(np.asarray([[49406, 1000, 49407] + [0] * 74])),
                         method=jp.model.encode_text)
    got = port.model.encode_text(torch.tensor([[49406, 1000, 49407] + [0] * 74]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_timm_layout(timm):
    """ImageNet statistics, a biased patch conv, no ln_pre, erf GELU in the
    vision MLPs and QuickGELU in the text tower."""
    _, _, port = timm
    assert port.mean.tolist() == pytest.approx(IMAGENET_MEAN) and port.std.tolist() == pytest.approx(IMAGENET_STD)
    keys = set(port.model.state_dict())
    assert "visual.conv1.bias" in keys and not any(k.startswith("visual.ln_pre") for k in keys)
    assert port.model.visual.transformer.resblocks[0].mlp.act is F.gelu
    assert port.model.transformer.resblocks[0].mlp.act is quick_gelu


def test_slip_layout_round_trip(timm):
    """The port's state dict renamed to SLIP's layout converts (JAX
    ``convert_slip_clip``) to the same flax params it was bridged from."""
    from pixray_tpu_torch.models.clip.checkpoint import slip_name

    jp, variables, port = timm
    sd = {k: v.numpy() for k, v in port.model.state_dict().items()}
    slip = {k: sd[slip_name(k)] for k in _slip_keys(jp.config)}
    slip["visual.cls_token"] = slip["visual.cls_token"].reshape(1, 1, -1)
    slip["visual.pos_embed"] = slip["visual.pos_embed"][None]
    back = convert_slip_clip(slip, jp.config)["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf))


def _slip_keys(config):
    from pixray_tpu.models.signatures import slip_clip_signature

    return list(slip_clip_signature(config).keys())
