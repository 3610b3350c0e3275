"""Wallpaper filter: random rolls, with an optional half-shifted second row
(``shift``) or seam-matching losses (``--wallpaper_edge_match``), for
tileable outputs (port of ``pixray_tpu/filters/wallpaper.py``).

The draws are taken in the input's range, as the JAX filter takes them:
``shift`` rolls the doubled 2h-tall image by a row drawn in [0, h), and the
edge-matching modes roll the cropped image by shifts drawn over the
uncropped one.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.filters.base import FilterInterface, draw_shifts, roll


class WallpaperFilter(FilterInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--wallpaper_type", type=str, help="none, shift, horizontal, vertical", default=None, dest="wallpaper_type")
        parser.add_argument("--wallpaper_edge_match", type=int, help="force repeating match in pixels", default=0, dest="wallpaper_edge_match")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        self.wallpaper_type = settings.wallpaper_type
        self.edge_match = settings.wallpaper_edge_match

    def out_shape(self, h, w):
        crop = 2 * (self.edge_match // 2)
        if self.wallpaper_type == "shift":
            return 2 * h, w
        if self.wallpaper_type == "horizontal":
            return h, w - crop
        if self.wallpaper_type == "vertical":
            return h - crop, w
        return h - crop, w - crop

    def draw(self, gen, h, w):
        return draw_shifts(gen, h, w)

    def __call__(self, img, draws):
        h, w = img.shape[0], img.shape[1]
        rand_h, rand_w = draws[0], draws[1]
        loss = img.new_zeros(())
        em = self.edge_match
        em2 = em // 2

        if self.wallpaper_type == "shift":
            row2 = torch.roll(img, shifts=w // 2, dims=1)
            img = roll(roll(torch.cat([img, row2], dim=0), rand_h, 0), rand_w, 1)
        elif self.wallpaper_type == "horizontal":
            if em:
                loss = torch.mean((img[:, :em] - img[:, -em:]) ** 2) / em
                img = img[:, em2 : w - em2]
            img = roll(img, rand_w, 1)
        elif self.wallpaper_type == "vertical":
            if em:
                loss = torch.mean((img[:em] - img[-em:]) ** 2) / em
                img = img[em2 : h - em2]
            img = roll(img, rand_h, 0)
        else:
            if em:
                loss1 = torch.mean((img[:, :em] - img[:, -em:]) ** 2) / em
                img = img[:, em2 : w - em2]
                loss2 = torch.mean((img[:em] - img[-em:]) ** 2) / em
                img = img[em2 : h - em2]
                loss = loss1 + loss2
            img = roll(roll(img, rand_h, 0), rand_w, 1)
        return img, loss
