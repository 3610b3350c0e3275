"""Smoothness loss: a gradient-magnitude penalty on the cutouts, with an
optional gaussian pre-blur and default/clipped/log shaping (port of
``pixray_tpu/losses/smoothness.py``: ``torch.gradient(edge_order=1)``'s
semantics over the cutouts stacked into one tall image; the blur pads by
edge replication).

One deliberate difference: where a pixel's gradient magnitude is exactly 0
(a flat stretch, which bf16 cutouts hold wherever a cut's noise factor is
below the bf16 step), the square root takes gradient 0, where JAX's (and
``torch.sqrt``'s) is inf·0 = NaN and turns the whole latent to NaN after
one step.  The value is the same."""

from __future__ import annotations

import torch

from pixray_tpu_torch.losses.base import LossInterface


def gradient_1d(x, dim: int, spacing: float = 1.0):
    """``torch.gradient(edge_order=1)`` along ``dim``: one-sided differences
    at the edges, central inside, in the JAX package's order of operations."""
    x = torch.movedim(x, dim, 0)
    inner = (x[2:] - x[:-2]) / (2.0 * spacing)
    first = (x[1:2] - x[0:1]) / spacing
    last = (x[-1:] - x[-2:-1]) / spacing
    return torch.movedim(torch.cat([first, inner, last], dim=0), 0, dim)


def sqrt_zero_grad(x):
    """``sqrt(x)`` for x >= 0 with gradient 0 at x = 0 (the untaken branch's
    argument is kept away from 0 so that no inf·0 reaches the gradient)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def gaussian_kernel_1d(size: int, sigma: float):
    n = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    w = torch.exp(-(n**2) / (2.0 * sigma**2))
    return w / torch.sum(w)


def gaussian_blur(images, taps):
    """Separable depthwise blur of (..., H, W, C) ``images`` by the 1-D
    ``taps`` (on the images' device), padding by edge replication."""
    size = taps.shape[0]
    pad = size // 2

    def blur_axis(x, dim):
        x = torch.movedim(x, dim, -1)
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], pad), x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)
        out = torch.zeros_like(x)
        for i in range(size):
            out = out + taps[i] * xp[..., i:i + x.shape[-1]]
        return torch.movedim(out, -1, dim)

    return blur_axis(blur_axis(images, -3), -2)


class SmoothnessLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--smoothness_weight", type=float, help="strength of smoothness loss effect", default=1, dest="smoothness_weight")
        parser.add_argument("--smoothness_type", type=str, help="default/clipped/log", default="default", dest="smoothness_type")
        parser.add_argument("--smoothness_gaussian_kernel", type=int, help="gaussian blur kernel size (0=off)", default=0, dest="smoothness_gaussian_kernel")
        parser.add_argument("--smoothness_gaussian_std", type=float, help="gaussian blur std", default=1, dest="smoothness_gaussian_std")
        parser.add_argument("--smoothness_spacing", type=int, help="gradient spacing", default=1, dest="smoothness_spacing")
        parser.add_argument("--smoothness_edge_order", type=int, help="(edge_order=1 supported)", default=1, dest="smoothness_edge_order")
        return parser

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        losses = []
        size = int(args.smoothness_gaussian_kernel)
        for _, cutouts in cur_cutouts.items():
            x = cutouts
            if size:
                taps = self.constant(("taps", size, args.smoothness_gaussian_std), x.device,
                                     lambda: gaussian_kernel_1d(size, args.smoothness_gaussian_std))
                x = gaussian_blur(x, taps)
            # all cutouts stacked into one tall (N*H, W, 3) image, differentiated across the stack
            x = x.reshape(-1, x.shape[-2], 3)
            gy = gradient_1d(x, 0, float(args.smoothness_spacing))
            gx = gradient_1d(x, 1, float(args.smoothness_spacing))
            sharpness = sqrt_zero_grad(torch.sum(gy**2, dim=-1) + torch.sum(gx**2, dim=-1))
            if args.smoothness_type == "clipped":
                sharpness = torch.clamp(sharpness, max=0.5)
            elif args.smoothness_type == "log":
                sharpness = torch.log1p(sharpness)
            losses.append(torch.mean(sharpness) * args.smoothness_weight)
        return losses
