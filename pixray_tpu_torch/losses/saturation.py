"""Saturation loss: the negative Hasler–Süsstrunk colourfulness of the
cutouts (port of ``pixray_tpu/losses/saturation.py``; variances with ddof 1)."""

from __future__ import annotations

import torch

from pixray_tpu_torch.losses.base import LossInterface


class SaturationLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--saturation_weight", type=float, help="strength of saturation loss effect", default=1, dest="saturation_weight")
        return parser

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        losses = []
        for _, cutouts in cur_cutouts.items():
            pixels = cutouts.reshape(-1, 3)
            rg = pixels[:, 0] - pixels[:, 1]
            yb = 0.5 * (pixels[:, 0] + pixels[:, 1]) - pixels[:, 2]
            std_rggb = torch.sqrt(torch.var(rg, correction=1) + torch.var(yb, correction=1))
            mean_rggb = torch.sqrt(torch.mean(rg) ** 2 + torch.mean(yb) ** 2)
            colorfulness = std_rggb + 0.3 * mean_rggb
            losses.append(-colorfulness * args.saturation_weight / 10.0)
        return losses
