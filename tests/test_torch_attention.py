"""The port's attention (``pixray_tpu_torch/ops/attention.py``) on the CPU:
its plain version, which does the CUDA kernels' arithmetic, against the JAX
package's ``MultiHeadAttention`` (the fused default and
``PIXRAY_TPU_CLIP_ATTN=einsum``) and its gradient against autograd through
the port's former formulation (plain matmul + softmax).

Tolerances: float32, 2e-5 absolute on outputs and gradients of unit scale
(the same sums in another order: the softmax through the log-sum-exp, JAX's
fused path, autograd's own backward).  In bf16 the plain version rounds
where the kernels do (P and dS as product operands, each output once); that
is held bitwise against the arithmetic written out here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.models.clip.model import MultiHeadAttention as JMultiHeadAttention
from pixray_tpu_torch.engine import step as engine_step
from pixray_tpu_torch.models.clip.model import MultiHeadAttention
from pixray_tpu_torch.ops import attention as A

ATOL = 2e-5

# (batch, tokens, heads, head dim, causal): TinyTest's vision (17 tokens) and
# text towers (head dim 32), ViT-B/32's 50 tokens, a text tower's 77 causal,
# ViT-B/16's 197 (head dim 64; two heads keep the CPU's work small)
CASES = {
    "tiny_vision": (2, 17, 2, 32, False),
    "tiny_text": (2, 77, 2, 32, True),
    "vitb32": (2, 50, 2, 64, False),
    "text": (2, 77, 2, 64, True),
    "vitb16": (2, 197, 2, 64, False),
}


def former(qkv, heads, causal):
    """The port's attention before the fused kernel (plain matmul + softmax)."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
    return former_heads(q, k, v, causal).transpose(1, 2).reshape(b, t, d)


def former_heads(q, k, v, causal):
    t, hd = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
    if causal:
        scores = scores.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    return torch.matmul(torch.softmax(scores, dim=-1).to(q.dtype), v)


def packed(b, t, heads, hd, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, t, 3 * heads * hd), generator=gen)
    dout = torch.randn((b, t, heads * hd), generator=gen)
    return qkv.to(dtype), dout.to(dtype)


@pytest.mark.parametrize("mode", ["fused", "einsum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_attention(case, mode, monkeypatch):
    """in_proj, attention, out_proj against the JAX module, in float32."""
    monkeypatch.setenv("PIXRAY_TPU_CLIP_ATTN", mode)
    b, t, heads, hd, causal = CASES[case]
    d = heads * hd
    x = np.random.RandomState(len(case) + t).randn(b, t, d).astype(np.float32)
    mask = np.tril(np.ones((t, t), bool)) if causal else None
    module = JMultiHeadAttention(num_heads=heads, dtype=jnp.float32)
    params = module.init(jax.random.PRNGKey(t), x, mask)["params"]
    want = np.asarray(module.apply({"params": params}, x, mask))
    p = {name: {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()} for name, leaf in params.items()}
    qkv = torch.from_numpy(x) @ p["in_proj"]["kernel"] + p["in_proj"]["bias"]
    got = A.attention(qkv, heads, causal) @ p["out_proj"]["kernel"] + p["out_proj"]["bias"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_former_autograd(case):
    """The plain backward (P from the LSE, dS = P (dP - rowsum(dO O))) against
    autograd through plain matmul + softmax, and the forward likewise."""
    b, t, heads, hd, causal = CASES[case]
    qkv, dout = packed(b, t, heads, hd, seed=t)
    x = qkv.clone().requires_grad_()
    out = A.attention(x, heads, causal)
    (got,) = torch.autograd.grad(out, x, dout)
    y = qkv.clone().requires_grad_()
    ref = former(y, heads, causal)
    (want,) = torch.autograd.grad(ref, y, dout)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["tiny_text", "vitb16"])
def test_packed_gradient_is_the_heads_gradients(case):
    """The one (B, T, 3D) gradient equals the cat of the three head-major
    gradients that autograd gives separate q, k, v leaves."""
    b, t, heads, hd, causal = CASES[case]
    qkv, dout = packed(b, t, heads, hd, seed=7)
    x = qkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(A.attention(x, heads, causal), x, dout)
    leaves = [z.reshape(b, t, heads, hd).transpose(1, 2).clone().requires_grad_() for z in qkv.chunk(3, dim=-1)]
    out = former_heads(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, dout.reshape(b, t, heads, hd).transpose(1, 2))
    want = torch.cat([g.transpose(1, 2).reshape(b, t, heads * hd) for g in grads], dim=-1)
    assert got.shape == qkv.shape
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["vitb32", "text", "vitb16"])
def test_bf16_rounds_where_the_kernel_does(case):
    """A bf16 CPU call: scores, softmax and sums in float32, bf16 only at P
    (PV's operand), dS (the dq and dk products' operand) and each output;
    bitwise the arithmetic written out here.  Against float32 throughout its
    output lies within a bf16 rounding of the largest element."""
    b, t, heads, hd, causal = CASES[case]
    qkv, dout = packed(b, t, heads, hd, seed=11, dtype=torch.bfloat16)
    x = qkv.clone().requires_grad_()
    out = A.attention(x, heads, causal)
    (dqkv,) = torch.autograd.grad(out, x, dout)
    assert out.dtype == dqkv.dtype == torch.bfloat16

    split = lambda z, n: [w.reshape(b, t, heads, hd).transpose(1, 2).float() for w in z.chunk(n, dim=-1)]
    merge = lambda z: z.transpose(1, 2).reshape(b, t, heads * hd)
    q, k, v = split(qkv, 3)
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    p16 = p.bfloat16().float()
    want = merge(torch.matmul(p16, v)).bfloat16()
    assert torch.equal(out, want)
    do, o = split(dout, 1)[0], split(out, 1)[0]
    ds16 = (p * (torch.matmul(do, v.transpose(-1, -2)) - (do * o).sum(-1, keepdim=True))).bfloat16().float()
    grads = (torch.matmul(ds16, k) * hd ** -0.5, torch.matmul(ds16.transpose(-1, -2), q) * hd ** -0.5,
             torch.matmul(p16.transpose(-1, -2), do))
    assert torch.equal(dqkv, torch.cat([merge(g) for g in grads], dim=-1).bfloat16())

    exact = merge(torch.matmul(torch.softmax(s, -1), v))
    assert float((out.detach().float() - exact).abs().max()) <= 2.0 ** -7 * float(exact.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_module_takes_the_kernel_path_in_bf16_only(dtype):
    """MultiHeadAttention: a bf16 input goes through ``attention`` (the
    kernel on the card, its plain version here); float32 keeps plain
    matmul + softmax, bitwise as before."""
    torch.manual_seed(3)
    width, heads, t = 128, 2, 50
    mha = MultiHeadAttention(width, heads)
    with torch.no_grad():
        for prm in mha.parameters():
            prm.normal_(0, width ** -0.5)
    mha = mha.to(dtype)
    x = torch.randn((2, t, width)).to(dtype)
    qkv = torch.nn.functional.linear(x, mha.in_proj_weight, mha.in_proj_bias)
    inner = A.attention(qkv, heads) if dtype == torch.bfloat16 else former(qkv, heads, False)
    assert torch.equal(mha(x), mha.out_proj(inner))


def test_cuda_launchers_refuse_cpu_tensors_and_bad_shapes():
    qkv, dout = packed(1, 5, 2, 64, seed=1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.launch_fwd(qkv, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.launch_bwd(qkv, dout, torch.zeros((1, 2, 5)), dout, 2)
    with pytest.raises(ValueError, match="3 \\* heads"):
        A.attention(qkv[..., :-1], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        A.attention(qkv.to("meta"), 2)


def test_block_replays_advance_the_attention_counters():
    """A replayed block adds what its capture recorded to every launch counter, the attention kernels' too."""
    assert any(counter is A.LAUNCHES for counter in engine_step.LAUNCH_COUNTERS)
    assert set(A.LAUNCHES) == set(A.KERNEL_NAMES) == {"attn_fwd", "attn_bwd"}
