"""Gradient-shaping primitives (port of ``pixray_tpu/ops/grad.py``).

- ``replace_grad``: forward one value, route the gradient to another (the
  prompt stop-threshold trick);
- ``clamp_with_grad``: clamp whose backward zeroes only the gradient
  components that push further out of range;
- ``spherical_dist_loss``: squared great-circle distance of unit vectors.
"""

from __future__ import annotations

import torch


class _ReplaceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_forward, x_backward):
        ctx.shape = x_backward.shape
        return x_forward.clone()

    @staticmethod
    def backward(ctx, g):
        # sum the cotangent down to the backward operand's shape (broadcast adjoint)
        shape = ctx.shape
        extra = g.dim() - len(shape)
        axes = tuple(range(extra)) + tuple(
            i + extra for i, s in enumerate(shape) if g.shape[i + extra] != s
        )
        summed = g.sum(dim=axes) if axes else g
        return None, summed.reshape(shape)


def replace_grad(x_forward, x_backward):
    return _ReplaceGrad.apply(x_forward, x_backward)


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        keep = (g * (x - x.clamp(lo, hi)) >= 0).to(g.dtype)
        return g * keep, None, None


def clamp_with_grad(x, lo: float, hi: float):
    return _ClampWithGrad.apply(x, lo, hi)


def l2_normalize(x, dim=-1, eps=1e-12):
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.maximum(norm, norm.new_full((), eps))


def spherical_dist_loss(x, y):
    x = l2_normalize(x, dim=-1)
    y = l2_normalize(y, dim=-1)
    chord = torch.linalg.vector_norm(x - y, dim=-1)
    return torch.square(torch.arcsin(chord / 2)) * 2
