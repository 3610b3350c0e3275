"""Dynamically quantized int8 matmuls for the vision towers (port of ``pixray_tpu/ops/quant.py``).

The ``int8`` and ``int8b`` rungs of ``PIXRAY_TPU_CLIP_PREC``: symmetric
absmax quantization, activations per row (token) and weights per column
(output feature), an s8 x s8 -> s32 product, then the dequant
``(acc * sx) * sw`` in float32.  The backward is straight-through:
``bwd="bf16"`` takes dx = g @ W^T from bf16 operands with float32
accumulation and output; ``bwd="int8"`` quantizes the cotangent (per row)
and the weights (per input feature) the same way.

The s8 product: on CUDA ``torch._int_mm`` (cuBLAS's int8 GEMM; it wants
more than 16 rows and K and N multiples of 8, and a shape it refuses
raises); on the CPU a float64 product of the integer values, exact while
the sums stay below 2^53 (|sum| <= 127 * 127 * K), so the int32 result
equals XLA's int32 dot.  The bf16 x bf16 -> float32 product: on CUDA
``torch.mm(..., out_dtype=torch.float32)`` (bf16 tensor cores, float32
output; PyTorch 2.8 and later), on the CPU the bf16 values as float32
(exact products, float32 sums).

``torch._int_mm`` reads its second operand fastest column-major (the
"TN" layout): on an H100 (PyTorch 2.11, CUDA 12.8) a row-major (K, N)
operand took 4-8 times as long at the ViT-B/32 bank's shapes and was
refused at 17 x 64 x 192 (``chip_smoke.py`` phase 33 prints both).

Pre-quantized weights (:func:`prequantize_kernel`, made once at load)
carry two layouts, ``q`` (D, F) and ``qt`` (F, D), both contiguous, so
the forward and the dx product each read one without a per-step copy.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def _over_127(m):
    """m / 127 as a true division: PyTorch's CUDA division by a Python
    scalar is a product with its float32 reciprocal, which can move the
    scale by an ulp and a code with it."""
    return m / torch.full_like(m, 127.0)


def quantize_last_axis(x32, eps: float = EPS):
    """Symmetric per-row int8 quantization along the last axis: (q s8, s f32 (..., 1))."""
    s = _over_127(torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=eps))
    return torch.round(x32 / s).to(torch.int8), s


def quantize_columns(w32, eps: float = EPS):
    """Per-column quantization of a (D, F) matrix: (q s8 (D, F), s f32 (1, F))."""
    s = _over_127(torch.clamp(w32.abs().amax(dim=0, keepdim=True), min=eps))
    return torch.round(w32 / s).to(torch.int8), s


def int_mm(a, b):
    """(M, K) s8 @ (K, N) s8 -> (M, N) int32, exact."""
    if a.device.type == "cuda":
        return torch._int_mm(a, b)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def bf16_mm_f32(a, b):
    """(M, K) @ (K, N) with both operands rounded to bf16 and a float32
    result from float32 accumulation (XLA's ``preferred_element_type``)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _rows(x):
    """(..., D) -> (M, D) contiguous."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def int8_dot(x, w):
    """(..., D) x (D, F) with dynamic scales on both sides; float32 (..., F).
    The weights are quantized as the rows of w^T (per column of w, the
    same codes), so ``torch._int_mm`` reads them column-major."""
    xq, sx = quantize_last_axis(_rows(x).float())
    wq_t, sw = quantize_last_axis(w.float().t().contiguous())
    acc = int_mm(xq, wq_t.t())
    return (acc.float() * sx * sw.t()).reshape(*x.shape[:-1], w.shape[1])


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bwd):
        ctx.save_for_backward(x, w)
        ctx.bwd = bwd
        return int8_dot(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = _rows(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.bwd == "int8":
                dx = int8_dot(g2, w.float().t())
            else:
                dx = bf16_mm_f32(g2, w.t())
            dx = dx.to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = bf16_mm_f32(_rows(x).t(), g2).to(w.dtype)
        return dx, dw, None


def int8_matmul(x, w, bwd: str = "bf16"):
    """x (..., D) @ w (D, F) with the int8 forward and a ``bwd`` ("bf16" or
    "int8") straight-through backward; float32 out.  The weight's
    cotangent (bf16 operands, float32 accumulation) is made only where
    ``w`` asks for one: the towers' weights are frozen."""
    return _Int8Matmul.apply(x, w, bwd)


class QuantWeight:
    """A (D, F) kernel pre-quantized per column: ``q`` (D, F) and ``qt``
    (F, D) s8, both contiguous, and ``s`` (1, F) float32."""

    def __init__(self, q, s):
        self.q, self.s = q.contiguous(), s.contiguous()
        self.qt = q.t().contiguous()


def prequantize_kernel(w) -> QuantWeight:
    """Symmetric per-column int8 quantization of a (D, F) kernel, the
    dynamic path's weight quantize: ``q * s ~ w``."""
    return QuantWeight(*quantize_columns(torch.as_tensor(w).float()))


def _mat2(qw: QuantWeight, transpose: bool):
    """The s8 operand of the forward (D, F) or of the dx product (F, D),
    in the layout ``torch._int_mm`` reads: a view, never a copy."""
    return qw.qt.t() if not transpose else qw.q.t()


def int8_dot_pre(x, qw: QuantWeight):
    """(..., D) @ (q * s): activations quantized per row; float32 (..., F)."""
    xq, sx = quantize_last_axis(_rows(x).float())
    acc = int_mm(xq, _mat2(qw, False))
    return (acc.float() * sx * qw.s).reshape(*x.shape[:-1], qw.q.shape[1])


class _Int8MatmulPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qw, bwd):
        ctx.qw, ctx.bwd, ctx.x_dtype, ctx.x_shape = qw, bwd, x.dtype, x.shape
        return int8_dot_pre(x, qw)

    @staticmethod
    def backward(ctx, g):
        qw = ctx.qw
        gs = _rows(g).float() * qw.s  # fold the per-column weight scales into g
        if ctx.bwd == "int8":
            gq, sg = quantize_last_axis(gs)
            dx = int_mm(gq, _mat2(qw, True)).float() * sg
        else:
            dx = bf16_mm_f32(gs, qw.qt)
        return dx.to(ctx.x_dtype).reshape(ctx.x_shape), None, None


def int8_matmul_pre(x, qw: QuantWeight, bwd: str = "bf16"):
    """x (..., D) @ (qw.q * qw.s) with pre-quantized weights.  The backward
    folds ``s`` into the cotangent so the same s8 weights serve the dx
    product: dx[..., d] = sum_f g[..., f] s[f] q[d, f]; with ``bwd="int8"``
    the folded cotangent is quantized per row (the int8b rung)."""
    return _Int8MatmulPre.apply(x, qw, bwd)
