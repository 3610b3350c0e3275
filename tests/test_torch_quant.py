"""``pixray_tpu_torch/ops/quant.py`` against ``pixray_tpu/ops/quant.py`` on seeded inputs.

Tolerances: the quantization (codes and scales), ``prequantize_kernel``
and the forwards are bitwise (the same float32 divisions, half-to-even
rounding and exact integer sums, then ``(acc * sx) * sw``); so is the
int8 dx, whose product is again exact.  The bf16 dx and the weight's
cotangent take bf16 x bf16 products summed in float32 in another order
than XLA's dot: within 1e-5 of the largest element, and one bf16 ulp
(2^-8 relative) where the result is rounded to a bf16 input's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops import quant as J
from pixray_tpu_torch.ops import quant as Q

SHAPES = [((2, 20, 64), (64, 48)), ((37, 24), (24, 40))]
F32_RTOL = 1e-5  # of max|ref|: float32 sums in another order


def _data(xshape, wshape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(xshape) * scale).astype(np.float32)
    w = (rng.standard_normal(wshape) * 0.1).astype(np.float32)
    w[:, 3] = 0.0  # a zero column: the eps floor of its scale
    g = rng.standard_normal((*xshape[:-1], wshape[1])).astype(np.float32)
    return x, w, g


def _close(port, ref, rtol=F32_RTOL):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * max(float(np.abs(ref).max()), 1e-30))


def _bits_equal(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_prequantize_are_bitwise(seed):
    x, w, _ = _data((5, 33), (33, 16), seed, scale=3.0)
    x[1] = 0.0  # an all-zero row: the eps floor
    q, s = Q.quantize_last_axis(torch.tensor(x))
    jq, js = J._quantize_last_axis(jnp.asarray(x))
    assert q.dtype == torch.int8
    _bits_equal(q.numpy(), jq)
    _bits_equal(s.numpy(), js)
    qw = Q.prequantize_kernel(torch.tensor(w))
    jwq, jsw = J.prequantize_kernel(jnp.asarray(w))
    _bits_equal(qw.q.numpy(), jwq)
    _bits_equal(qw.s.numpy(), jsw)
    _bits_equal(qw.qt.numpy(), np.asarray(jwq).T)
    # half-to-even rounding, as jnp.round
    assert Q.quantize_last_axis(torch.tensor([[2.5 / 127 * 10, 10.0, -0.5 / 127 * 10]]))[0].tolist() == [[2, 127, 0]]


@pytest.mark.parametrize("xshape,wshape", SHAPES)
def test_forwards_are_bitwise(xshape, wshape):
    x, w, _ = _data(xshape, wshape, 3)
    _bits_equal(Q.int8_dot(torch.tensor(x), torch.tensor(w)).numpy(), J._int8_dot(jnp.asarray(x), jnp.asarray(w)))
    jwq, jsw = J.prequantize_kernel(jnp.asarray(w))
    port = Q.int8_dot_pre(torch.tensor(x), Q.prequantize_kernel(torch.tensor(w)))
    _bits_equal(port.numpy(), J._int8_dot_pre(jnp.asarray(x), jwq, jsw))
    # the autograd Functions' forwards are the dots
    _bits_equal(Q.int8_matmul(torch.tensor(x), torch.tensor(w), "int8").numpy(),
                J.int8_matmul(jnp.asarray(x), jnp.asarray(w), "int8"))


def _jax_vjp(fn, *primals, g):
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(jnp.asarray(g))


@pytest.mark.parametrize("bwd", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xshape,wshape", SHAPES)
def test_int8_matmul_vjp(xshape, wshape, dtype, bwd):
    """dx and dw of the dynamic rung; int8 dx bitwise, bf16 dx and dw within F32_RTOL (one bf16 ulp in bf16)."""
    x, w, g = _data(xshape, wshape, 4)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    out, (jdx, jdw) = _jax_vjp(lambda a, b: J.int8_matmul(a, b, bwd), jx, jw, g=g)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(tdt).requires_grad_(True)
    y = Q.int8_matmul(tx, tw, bwd)
    _bits_equal(y.detach().numpy(), out)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.tensor(g))
    assert dx.dtype == tdt and dw.dtype == tdt
    rtol = F32_RTOL if dtype == "float32" else 2.0 ** -8
    if bwd == "int8" and dtype == "float32":
        _bits_equal(dx.numpy(), jdx)
    else:
        _close(dx.float().numpy(), np.asarray(jdx.astype(jnp.float32)), rtol)
    _close(dw.float().numpy(), np.asarray(jdw.astype(jnp.float32)), rtol)


@pytest.mark.parametrize("bwd", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xshape,wshape", SHAPES)
def test_int8_matmul_pre_vjp(xshape, wshape, dtype, bwd):
    """The pre-quantized rung: forward bitwise, dx (s folded into g) int8 bitwise, bf16 within F32_RTOL."""
    x, w, g = _data(xshape, wshape, 5)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jwq, jsw = J.prequantize_kernel(jnp.asarray(w))
    out, vjp = jax.vjp(lambda a: J.int8_matmul_pre(a, jwq, jsw, bwd), jx)
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
    y = Q.int8_matmul_pre(tx, Q.prequantize_kernel(torch.tensor(w)), bwd)
    _bits_equal(y.detach().numpy(), out)
    (dx,) = torch.autograd.grad(y, tx, torch.tensor(g))
    assert dx.dtype == tdt
    if bwd == "int8" and dtype == "float32":
        _bits_equal(dx.numpy(), jdx)
    else:
        _close(dx.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
               F32_RTOL if dtype == "float32" else 2.0 ** -8)


def test_int_mm_is_exact_on_the_cpu():
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, (19, 3072), dtype=np.int8)
    b = rng.integers(-127, 128, (3072, 24), dtype=np.int8)
    got = Q.int_mm(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    # float32 output of bf16-rounded operands, float32 sums
    x = torch.randn(7, 40, generator=torch.Generator().manual_seed(0))
    y = torch.randn(40, 5, generator=torch.Generator().manual_seed(1))
    want = x.bfloat16().double() @ y.bfloat16().double()
    got = Q.bf16_mm_f32(x, y)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
