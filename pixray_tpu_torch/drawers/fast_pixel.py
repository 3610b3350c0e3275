"""Fast pixel drawer: the latent is a low-resolution RGB grid, the render a
nearest-neighbour upsample (port of ``pixray_tpu/drawers/fast_pixel.py``).

Grid sizing follows the pixel drawer's heuristic; the latent lives in
[0, 1] and is clamped after each step; ``params_from_image`` is
``jax.image.resize``'s antialiased bilinear downsample
(``ops/pool.py`` ``linear_resize``).
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.ops.grad import clamp_with_grad
from pixray_tpu_torch.ops.pool import linear_resize, nearest_resize


def grid_for_canvas(settings):
    """(num_cols, num_rows) of the grid for ``settings.size``."""
    w, h = settings.size
    if getattr(settings, "pixel_size", None) is not None:
        num_cols, num_rows = settings.pixel_size
    elif w == h:
        num_cols, num_rows = 40, 40
    elif w < h:
        num_cols, num_rows = 40, 50
    else:
        num_cols, num_rows = 80, 45

    pixel_scale = getattr(settings, "pixel_scale", None)
    if pixel_scale is not None and pixel_scale > 0:
        num_cols = int(num_cols / pixel_scale)
        num_rows = int(num_rows / pixel_scale)
    return min(num_cols, w), min(num_rows, h)


class FastPixelDrawer:
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--pixel_size", nargs=2, type=int, help="Pixel size (width height)", default=None, dest="pixel_size")
        parser.add_argument("--pixel_scale", type=float, help="Pixel scale", default=None, dest="pixel_scale")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.num_cols, self.num_rows = grid_for_canvas(settings)
        self.model_params = {}
        print(f"Running fast pixeldrawer with {self.num_cols}x{self.num_rows} grid")

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        return self.canvas_width, self.canvas_height

    def init_params(self, gen, init_tensor=None):
        if init_tensor is None:
            return torch.rand((self.num_rows, self.num_cols, 3), generator=gen)
        return self.params_from_image(init_tensor)

    def params_from_image(self, image_tensor):
        img01 = (torch.as_tensor(image_tensor, dtype=torch.float32) + 1.0) / 2.0
        return linear_resize(img01, self.num_rows, self.num_cols)

    def clip_params(self, z):
        return z.clamp(0.0, 1.0)

    def synth(self, model_params, z, iteration=None):
        """(rows, cols, 3) latent → (H, W, 3) canvas in [0, 1]."""
        return clamp_with_grad(nearest_resize(z, self.canvas_height, self.canvas_width), 0.0, 1.0)
