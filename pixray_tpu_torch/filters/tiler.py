"""Tiler filter: a random toroidal x/y roll with zero loss, so CLIP scores
every seam phase and the result tiles (port of ``pixray_tpu/filters/tiler.py``)."""

from __future__ import annotations

from pixray_tpu_torch.filters.base import FilterInterface, draw_shifts, roll


class TilerFilter(FilterInterface):
    def draw(self, gen, h, w):
        return draw_shifts(gen, h, w)

    def __call__(self, img, draws):
        return roll(roll(img, draws[0], 0), draws[1], 1), img.new_zeros(())
