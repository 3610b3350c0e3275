"""Gaussian loss: pull the canvas away from its centre toward a colour,
weighted by |1 − gaussian window| (port of ``pixray_tpu/losses/gaussian.py``).

|out − colour| takes JAX's derivative of ``abs``, +1 at 0 (``torch.abs``
gives 0 there): a pixel equal to the colour, which a canvas clamped at
white or snapped to a palette holds, still gets the gradient JAX gives it."""

from __future__ import annotations

import torch

from pixray_tpu_torch.losses.base import LossInterface


def gaussian_window_2d(h, w, std_y, std_x):
    ny = torch.arange(h, dtype=torch.float32) - (h - 1.0) / 2.0
    nx = torch.arange(w, dtype=torch.float32) - (w - 1.0) / 2.0
    wy = torch.exp(-(ny**2) / (2 * std_y * std_y))
    wx = torch.exp(-(nx**2) / (2 * std_x * std_x))
    return torch.outer(wy, wx)


class GaussianLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--gaussian_weight", type=float, help="gaussian's weight", default=1, dest="gaussian_weight")
        parser.add_argument("--gaussian_std", nargs=2, type=float, help="std for y and x", default=(40, 40), dest="gaussian_std")
        parser.add_argument("--gaussian_color", nargs=3, type=float, help="target color (0-255)", default=(255, 255, 255), dest="gaussian_color")
        return parser

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        h, w = out.shape[0], out.shape[1]
        std, rgb = tuple(args.gaussian_std), tuple(args.gaussian_color)
        weight = self.constant(("window", h, w, std), out.device,
                               lambda: torch.abs(1.0 - gaussian_window_2d(h, w, *std))[..., None])
        color = self.constant(("color", rgb), out.device, lambda: torch.tensor(rgb, dtype=torch.float32) / 255.0)
        diff = out - color
        return torch.mean(torch.where(diff >= 0, diff, -diff) * weight) * args.gaussian_weight
