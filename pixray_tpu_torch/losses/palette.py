"""Palette loss: the mean distance of cutout pixels to their nearest palette
colour (port of ``pixray_tpu/losses/palette.py``; the nearest colour by the
expanded squared distance, first index on ties)."""

from __future__ import annotations

import torch

from pixray_tpu_torch.filters.lookup import nearest_colors
from pixray_tpu_torch.losses.base import LossInterface


class PaletteLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--palette_weight", type=float, help="strength of palette loss effect", default=1, dest="palette_weight")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        palette = settings.palette if settings is not None and settings.palette else None
        if palette is None:
            raise ValueError("palette loss requires --palette")
        self.palette = torch.tensor(palette, dtype=torch.float32)  # (K, 3)

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        losses = []
        for _, cutouts in cur_cutouts.items():
            palette = self.constant("palette", cutouts.device, lambda: self.palette)
            pixels = cutouts.reshape(-1, 3)
            diffs = pixels - palette[nearest_colors(pixels, palette)]
            loss = torch.mean(torch.linalg.vector_norm(diffs, dim=1)) * cutouts.shape[0]
            losses.append(loss * args.palette_weight / 10.0)
        return losses
