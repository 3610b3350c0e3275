"""Symmetry loss: MSE between the canvas and its horizontal flip (port of
``pixray_tpu/losses/symmetry.py``)."""

from __future__ import annotations

import torch

from pixray_tpu_torch.losses.base import LossInterface


class SymmetryLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--symmetry_weight", type=float, help="how much symmetry is weighted in loss", default=1, dest="symmetry_weight")
        return parser

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        return torch.mean((out - torch.flip(out, dims=(1,))) ** 2) * args.symmetry_weight
