"""The port's ModifiedResNet against the JAX package's, on the CPU in float32,
with the same weights carried across by the bridge (``params`` and
``batch_stats``, every BatchNorm made non-trivial: random scale, bias and
running mean, running variance in [0.5, 2]).

The towers are the tiny ResNet of ``tests/test_affine_fold.py`` (width 8,
one block per stage, 32 px: 1x1 after the stages) and a 64 px variant with
two blocks in stage 2 (2x2 after the stages, so the attention pool's token
order shows, and a stride-1 block that keeps its identity).

Tolerances: 1e-5 absolute on values of unit scale (f32 convolutions and
matmuls summed in another order), 1e-5 relative to the largest entry on
input gradients; the affine materialised against the affine given, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.models.clip.model import AttentionPool2d as JAttentionPool2d
from pixray_tpu.models.clip.model import Bottleneck as JBottleneck
from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.clip.model import AttentionPool2d, FrozenBatchNorm2d
from pixray_tpu_torch.models.clip.tokenizer import tokenize
from pixray_tpu_torch.models.perceptor import Perceptor
from torch_parity import randomize_batch_norms, tiny_towers  # noqa: F401

pytestmark = pytest.mark.usefixtures("tiny_towers")

ATOL = 1e-5
GRAD_RTOL = 1e-5
NAMES = ["TinyRN", "TinyRN64"]


@pytest.fixture(scope="module")
def towers(tiny_towers):
    out = {}
    for i, name in enumerate(NAMES):
        jp = JPerceptor(name, dtype=jnp.float32)
        variables = randomize_batch_norms(jp.variables, seed=i)
        port = Perceptor(name, "cpu", torch.float32, state_dict=state_dict_from_flax(variables, jp.config))
        out[name] = (jp, variables, port)
    return out


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", NAMES)
def test_image_fn_and_its_input_gradient_match(towers, name):
    """Channel-major cutouts in [0, 1] (and a little outside), the batch's
    range stretch and the CLIP standardization materialised before the stem,
    as the engine calls the tower."""
    jp, variables, port = towers[name]
    r = jp.input_resolution
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-0.1, 1.1, (3, 3, r, r)).astype(np.float32)
    cot = rng.standard_normal((3, jp.output_dim)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda x: jp.image_fn(variables, x, data_format="NCHW")), jnp.asarray(imgs))
    (ref_g,) = vjp(jnp.asarray(cot))
    x = torch.tensor(imgs, requires_grad=True)
    out = port.image_fn(x)
    (g,) = torch.autograd.grad(out, x, torch.tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    _close_grad(g.numpy(), np.asarray(ref_g))


@pytest.mark.parametrize("name", NAMES)
def test_encode_image_with_the_affine_materialised(towers, name):
    """``encode_image(images, (scale, shift))`` is the tower on
    ``images * scale + shift`` (tests/test_affine_fold.py's fallback), and
    both equal the JAX tower's."""
    jp, variables, port = towers[name]
    r = jp.input_resolution
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 3, r, r)).astype(np.float32)
    scale, shift = torch.tensor([2.0, 3.0, 4.0]), torch.tensor([-0.5, 0.0, 0.25])
    x = torch.tensor(imgs)
    folded = port.model.encode_image(x, (scale, shift))
    direct = port.model.encode_image(x * scale[:, None, None] + shift[:, None, None])
    np.testing.assert_allclose(folded.numpy(), direct.numpy(), atol=ATOL)
    ref = jax.jit(lambda x, a: jp.model.apply(variables, x, a, "NCHW", method=jp.model.encode_image))(
        jnp.asarray(imgs), (jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy())))
    np.testing.assert_allclose(folded.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("block", ["layer2_0", "layer2_1", "layer3_0"])
def test_bottleneck_matches(towers, block):
    """A downsampling block (stride 2: average pool after conv2 and before
    the downsample conv) and a stride-1 block with its identity."""
    jp, variables, port = towers["TinyRN64"]
    stage, idx = block.removeprefix("layer").split("_")
    mod = getattr(port.model.visual, f"layer{stage}")[int(idx)]
    cin, planes = mod.conv1.in_channels, mod.conv1.out_channels
    stride = mod.stride
    x = np.random.default_rng(3).standard_normal((2, 8, 6, cin)).astype(np.float32)
    sub = {"params": variables["params"]["visual"][block], "batch_stats": variables["batch_stats"]["visual"][block]}
    cot = np.random.default_rng(4).standard_normal((2, 8 // stride, 6 // stride, planes * 4)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: JBottleneck(planes, stride, dtype=jnp.float32).apply(sub, v), jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(cot))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = mod(xt)
    (g,) = torch.autograd.grad(out, xt, torch.tensor(cot.transpose(0, 3, 1, 2)))
    assert (mod.downsample is not None) == (block != "layer2_1")
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref), atol=ATOL)
    _close_grad(g.numpy().transpose(0, 2, 3, 1), np.asarray(ref_g))


def test_attention_pool_token_order_on_a_wide_map():
    """A 2x3 feature map (H != W) with a random positional table: the
    tokens flatten (h, w) row-major as the JAX pool's NHWC reshape does."""
    c, heads, out_dim = 128, 2, 24
    x = np.random.default_rng(5).standard_normal((3, 2, 3, c)).astype(np.float32)
    jpool = JAttentionPool2d(heads, out_dim, dtype=jnp.float32)
    params = jpool.init(jax.random.PRNGKey(6), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).standard_normal(a.shape).astype(np.float32) * 0.1, params)
    ref = jpool.apply(params, jnp.asarray(x))
    pool = AttentionPool2d(1, c, heads, out_dim)
    pool.positional_embedding = torch.nn.Parameter(torch.empty(7, c))
    p = params["params"]  # a Dense kernel is (in, out), a Linear weight (out, in)
    pool.load_state_dict({"positional_embedding": torch.tensor(p["positional_embedding"]),
                          **{f"{n}.{w}": torch.tensor(p[n][k].T if k == "kernel" else p[n][k])
                             for n in ("q_proj", "k_proj", "v_proj", "c_proj")
                             for w, k in (("weight", "kernel"), ("bias", "bias"))}})
    out = pool(torch.tensor(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_text_tower_matches(towers):
    """A ResNet CLIP's text tower is the ViT's (tolerance as tests/test_torch_clip.py)."""
    jp, variables, port = towers["TinyRN"]
    texts = ["sunrise", "a red barn"]
    ref = jp.model.apply(variables, jnp.asarray(tokenize(texts)), method=jp.model.encode_text)
    np.testing.assert_allclose(port.encode_text(texts).numpy(), np.asarray(ref), atol=1e-4)


def test_state_dict_has_openai_names_and_drops_num_batches_tracked(towers):
    jp, variables, port = towers["TinyRN64"]
    sd = state_dict_from_flax(variables, jp.config)
    assert set(sd) == set(port.model.state_dict())
    for key in ("visual.layer2.0.downsample.0.weight", "visual.layer2.0.downsample.1.running_var",
                "visual.attnpool.positional_embedding", "visual.attnpool.c_proj.bias", "visual.bn3.running_mean"):
        assert key in sd
    assert "visual.layer2.1.downsample.0.weight" not in sd
    with_count = dict(sd, **{"visual.bn1.num_batches_tracked": np.array(7)})
    again = Perceptor("TinyRN64", "cpu", torch.float32, state_dict=with_count)
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, port.model.state_dict()[k]), k


def test_bf16_storage_keeps_the_batch_norms_in_f32(tiny_towers):
    p = Perceptor("TinyRN64", "cpu", torch.bfloat16)
    v = p.model.visual
    assert v.conv1.weight.dtype == torch.bfloat16 and v.attnpool.q_proj.weight.dtype == torch.bfloat16
    assert v.attnpool.positional_embedding.dtype == torch.bfloat16
    bns = [m for m in v.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert len(bns) == 3 + 3 * 5 + 4  # the stem, five blocks, the first block of each stage
    assert all(t.dtype == torch.float32 for m in bns for t in m.buffers())
    assert v.layer1[0].conv2.weight.is_contiguous(memory_format=torch.channels_last)
    out = p.image_fn(torch.rand(2, 3, 64, 64))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_random_init_distributions(tiny_towers):
    """Seeded from the name; convs lecun-normal over k*k*c_in; BatchNorms
    at the identity; the attention pool's table normal(0.01)."""
    a, b = Perceptor("TinyRN64", "cpu"), Perceptor("TinyRN64", "cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    v = a.model.visual
    w = v.layer3[0].conv2.weight  # 32 -> 32 channels, 3x3
    assert abs(float(w.std()) - (9 * 32) ** -0.5) < 0.1 * (9 * 32) ** -0.5
    assert torch.equal(v.bn2.running_var, torch.ones(4)) and torch.equal(v.bn2.running_mean, torch.zeros(4))
    assert abs(float(v.attnpool.positional_embedding.std()) - 0.01) < 0.002
