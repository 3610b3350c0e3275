"""The vision towers' precision rungs against the JAX package on the CPU:
``PIXRAY_TPU_CLIP_PREC`` (bf16 / int8 / int8b) x ``PIXRAY_TPU_CLIP_PREQ``
x ``PIXRAY_TPU_CLIP_LN32`` on ``TinyTest`` and a tiny timm trunk
(``tests/torch_parity.py``, widths multiples of 8), both in bf16.

The JAX ``Perceptor`` is built directly, with the environment set: the
cached ``get_clip_perceptor`` ignores a later rung.  The port's tower gets
the JAX tower's float32 weights (the JAX package pre-quantizes from them,
not from its bf16 storage copy) and the rungs as arguments.

Tolerances and checks:
- the quant collection (every block's four dense kernels and the patch
  kernel in both row orders, codes and scales) equals the JAX
  ``variables["quant"]`` bitwise;
- embeddings (L2-normalized) within 1.5e-2; the input gradient within
  0.1 of its largest element and at a cosine of at least 0.998 to the
  JAX one.  Both towers compute in bf16 (the JAX side compiled without
  XLA's excess precision, so that it rounds each bf16 op as eager PyTorch
  does) and differ in where some sums round; the int8b rung re-quantizes
  each row of a cotangent that already differs by that rounding, and a
  code that moves moves 1/127 of its row's largest value.  Measured: the
  embeddings up to 1.1e-2 apart, the gradients up to 6.2e-2 of their
  largest element (int8b), cosines at least 0.9994.  The rungs' own ops
  are bitwise in tests/test_torch_quant.py;
- the rung is wired: the count of int8 products per call (four per block
  and the patch embedding, pre-quantized or not as ``PREQ`` says), and
  every LayerNorm's rung.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.models import perceptor as JP
from pixray_tpu_torch.config.precision import Rungs
from pixray_tpu_torch.models import perceptor as PP
from pixray_tpu_torch.models.clip import model as PM
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from torch_parity import jax_perceptor_cache, tiny_towers  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache", "tiny_towers")

EMBED_ATOL = 1.5e-2
GRAD_RTOL = 0.1
GRAD_COSINE = 0.998

# (tower, CLIP_PREC, PREQ, LN32): every value of every knob on TinyTest, three on the timm trunk
CASES = [
    ("TinyTest", "bf16", "1", "1"), ("TinyTest", "bf16", "1", "0"),
    ("TinyTest", "int8", "1", "0"), ("TinyTest", "int8b", "1", "0"),
    ("TinyTest", "int8", "0", "1"), ("TinyTest", "int8b", "0", "1"),
    ("TinyTimm48", "int8b", "1", "0"), ("TinyTimm48", "int8", "0", "1"), ("TinyTimm48", "bf16", "1", "0"),
]


def _jax_quant(q, layers):
    """The JAX quant collection under the port's keys: {key: (codes, scales)}."""
    v = q["visual"]
    out = {"visual.conv1.weight": (v["patch_q_cm"], v["patch_s_cm"]), PP.PATCH_NHWC: (v["patch_q"], v["patch_s"])}
    names = {"attn.in_proj_weight": ("attn", "in_proj"), "attn.out_proj.weight": ("attn", "out_proj"),
             "mlp.c_fc.weight": ("mlp_fc",), "mlp.c_proj.weight": ("mlp_proj",)}
    for i in range(layers):
        for name, path in names.items():
            node = v["transformer"][f"resblock_{i}"]
            for p in path:
                node = node[p]
            out[f"visual.transformer.resblocks.{i}.{name}"] = (node["kernel_q"], node["kernel_s"])
    return out


@pytest.mark.parametrize("name,prec,preq,ln32", CASES)
def test_tower_rung_matches_jax(name, prec, preq, ln32, monkeypatch):
    monkeypatch.setenv("PIXRAY_TPU_CLIP_PREC", prec)
    monkeypatch.setenv("PIXRAY_TPU_CLIP_PREQ", preq)
    monkeypatch.setenv("PIXRAY_TPU_CLIP_LN32", ln32)
    jp = JP.Perceptor(name, dtype=jnp.bfloat16)
    loaded = jp._load_variables(name)
    rungs = Rungs(clip=prec, clip_preq=preq == "1", clip_ln32=ln32 != "0")
    pp = PP.Perceptor(name, "cpu", torch.bfloat16, state_dict_from_flax(loaded["params"], jp.config), rungs=rungs)
    quant = prec if prec != "bf16" else None
    assert pp.quant == quant
    layers = jp.config.vision_layers

    # the quant collection, bitwise
    if quant and preq == "1":
        want = _jax_quant(jp.variables["quant"], layers)
        assert sorted(pp.quant_weights) == sorted(want)
        for key, (q, s) in want.items():
            np.testing.assert_array_equal(pp.quant_weights[key].q.numpy(), np.asarray(q), err_msg=key)
            np.testing.assert_array_equal(pp.quant_weights[key].s.numpy(), np.asarray(s), err_msg=key)
    else:
        assert pp.quant_weights is None and "quant" not in jp.variables
    assert all(m.ln32 == (ln32 != "0") for m in pp.model.modules() if isinstance(m, PM.LayerNorm))

    r = jp.input_resolution
    rng = np.random.default_rng(0)
    imgs = rng.random((4, 3, r, r)).astype(np.float32)
    proj = rng.standard_normal((4, jp.output_dim)).astype(np.float32)

    def scored(x):
        emb = jp.image_fn(jp.variables, x, data_format="NCHW")
        return jnp.sum(emb * proj), emb

    # XLA rounds every bf16 op as eager PyTorch does only without its excess precision
    step = jax.jit(jax.value_and_grad(scored, has_aux=True), compiler_options={"xla_allow_excess_precision": False})
    (_, ref), ref_grad = step(jnp.asarray(imgs))
    ref, ref_grad = np.asarray(ref), np.asarray(ref_grad)

    calls = {"pre": 0, "dynamic": 0}

    def spy(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(PM, "int8_matmul_pre", spy("pre", PM.int8_matmul_pre))
    monkeypatch.setattr(PM, "int8_matmul", spy("dynamic", PM.int8_matmul))
    x = torch.tensor(imgs, requires_grad=True)
    emb = pp.image_fn(x)
    (grad,) = torch.autograd.grad((emb * torch.tensor(proj)).sum(), x)
    n_int8 = 4 * layers + 1 if quant else 0
    assert calls == ({"pre": n_int8, "dynamic": 0} if preq == "1" else {"pre": 0, "dynamic": n_int8})
    np.testing.assert_allclose(emb.detach().numpy(), ref, rtol=0, atol=EMBED_ATOL)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=GRAD_RTOL * np.abs(ref_grad).max())
    g, r = grad.numpy().ravel().astype(np.float64), ref_grad.ravel().astype(np.float64)
    assert g @ r / np.linalg.norm(g) / np.linalg.norm(r) >= GRAD_COSINE


def test_rungs_leave_resnets_text_and_f32_towers(monkeypatch):
    """The int8 rung acts on a bf16 ViT vision tower only: not at float32,
    not on a ResNet; the text tower has no int8 product under any rung."""
    rungs = Rungs(clip="int8b", clip_ln32=False)
    f32 = PP.Perceptor("TinyTest", "cpu", torch.float32, rungs=rungs)
    assert f32.quant is None and f32.quant_weights is None
    rn = PP.Perceptor("TinyRN", "cpu", torch.bfloat16, rungs=rungs)
    assert rn.quant is None and rn.quant_weights is None
    vit = PP.Perceptor("TinyTest", "cpu", torch.bfloat16, rungs=rungs)
    assert vit.quant == "int8b" and len(vit.quant_weights) == 4 * 2 + 2
    assert all(blk.attn.quant is None and blk.mlp.quant is None for blk in vit.model.transformer.resblocks)
    calls = []
    monkeypatch.setattr(PM, "int8_matmul_pre", lambda *a: calls.append(1))
    vit.encode_text(["a red circle"])
    assert calls == []


@pytest.mark.parametrize("env,want", [
    ({}, Rungs(warp="highest", warp_bwd="bf16", clip="bf16", clip_preq=True, clip_ln32=True)),
    ({"PIXRAY_TPU_WARP_PREC": "int8", "PIXRAY_TPU_WARP_BWD_PREC": "int8", "PIXRAY_TPU_CLIP_PREC": "int8b",
      "PIXRAY_TPU_CLIP_PREQ": "1", "PIXRAY_TPU_CLIP_LN32": "0"},
     Rungs(warp="int8", warp_bwd="int8", clip="int8b", clip_preq=True, clip_ln32=False)),
    # the JAX package's own tests of the values: PREQ only "1" pre-quantizes, LN32 anything but "0" is f32
    ({"PIXRAY_TPU_CLIP_PREQ": "yes", "PIXRAY_TPU_CLIP_LN32": "2", "PIXRAY_TPU_CLIP_PREC": "fp8"},
     Rungs(clip="fp8", clip_preq=False, clip_ln32=True)),
])
def test_read_rungs(env, want):
    """The variables as the JAX package reads them; unset, the port's defaults."""
    from pixray_tpu_torch.config.precision import read_rungs

    got = read_rungs(env)
    assert got == want
    assert got.clip_quant(True) == (want.clip if want.clip in ("int8", "int8b") else None)
    assert got.clip_quant(False) is None
    with pytest.raises(ValueError):
        read_rungs({"PIXRAY_TPU_WARP_PREC": "fp8"})
