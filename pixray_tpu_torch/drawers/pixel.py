"""Pixel drawer: trainable RGBA fills of a cell grid (port of ``pixray_tpu/drawers/pixel.py``).

Grid sizing, latent init, image encoding and the post-step clamp follow
the JAX drawer.  The render is the separable two-matmul form
(``ops/cellrender.py``), which is exact for the rectangle grid; the other
cell geometries (rectshift, hex, tri, diamond, knit) are not ported yet.
``to_svg`` writes one polygon per cell, as the JAX drawer does.
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.ops.cellrender import (
    build_coverage_map,
    composite_cells_separable,
    try_separable_operators,
)
from pixray_tpu_torch.utils import str2bool

def rect_from_corners(p0, p1):
    x1, y1 = p0
    x2, y2 = p1
    return [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]


class PixelDrawer:
    has_alpha = True
    learning_rate = 0.03  # the engine divides it on LR drops

    @staticmethod
    def add_settings(parser):
        parser.add_argument("--pixel_size", nargs=2, type=int, help="Pixel size (width height)", default=None, dest="pixel_size")
        parser.add_argument("--pixel_scale", type=float, help="Pixel scale", default=None, dest="pixel_scale")
        parser.add_argument("--pixel_type", type=str, help="rect (the only geometry ported)", default="rect", dest="pixel_type")
        parser.add_argument("--pixel_edge_check", type=str2bool, help="ensure grid is symmetric", default=True, dest="pixel_edge_check")
        parser.add_argument("--pixel_iso_check", type=str2bool, help="ensure tri and hex shapes are w/h scaled", default=True, dest="pixel_iso_check")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        w, h = settings.size
        if settings.pixel_size is not None:
            self.num_cols, self.num_rows = settings.pixel_size
        elif w == h:
            self.num_cols, self.num_rows = 40, 40
        elif w < h:
            self.num_cols, self.num_rows = 40, 50
        else:
            self.num_cols, self.num_rows = 80, 45

        self.pixel_type = settings.pixel_type
        if self.pixel_type != "rect":
            raise NotImplementedError(
                f"pixel_type {self.pixel_type!r} is not yet ported to pixray_tpu_torch (rect only)"
            )

        if settings.pixel_scale is not None and settings.pixel_scale > 0:
            self.num_cols = int(self.num_cols / settings.pixel_scale)
            self.num_rows = int(self.num_rows / settings.pixel_scale)

        shrink = False
        if self.num_cols > w:
            shrink, self.num_cols = True, w
        if self.num_rows > h:
            shrink, self.num_rows = True, h
        if shrink:
            print("pixel grid size should not be larger than output pixel size: reducing pixel grid")
        print(f"Running pixeldrawer with {self.num_cols}x{self.num_rows} grid")

        self.transparent = settings.transparent
        self.model_params = None

    # ------------------------------------------------------------------ geometry
    def _cell_boxes(self):
        """Per-cell (row, col, x0, y0, x1, y1) boxes in draw order."""
        cw = self.canvas_width / self.num_cols
        ch = self.canvas_height / self.num_rows
        return [
            (r, c, c * cw, r * ch, c * cw + cw, r * ch + ch)
            for r in range(self.num_rows)
            for c in range(self.num_cols)
        ]

    def _build_geometry(self):
        if self.model_params is not None:
            return
        self.polygons = [
            np.asarray(rect_from_corners([x1, y1], [x2, y2]), dtype=np.float64)
            for _r, _c, x1, y1, x2, y2 in self._cell_boxes()
        ]
        self.num_cells = len(self.polygons)
        indices, valid = build_coverage_map(self.polygons, self.canvas_width, self.canvas_height)
        sep = try_separable_operators(indices, valid, self.num_rows, self.num_cols)
        if sep is None:
            raise NotImplementedError("non-separable pixel coverage maps are not yet ported")
        self.model_params = {
            "sep_row_op": torch.from_numpy(sep[0]),
            "sep_col_op": torch.from_numpy(sep[1]),
        }

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        self._build_geometry()
        return self.canvas_width, self.canvas_height

    # ------------------------------------------------------------------ latents
    def init_params(self, gen, init_tensor=None, rgb=None):
        """(cells, 4) RGBA latent: uniform colors (``rgb`` may inject the
        draw) or the mean colors of ``init_tensor`` ((H, W, 3) in [-1, 1])."""
        self._build_geometry()
        if init_tensor is not None:
            return self.params_from_image(init_tensor)
        if rgb is None:
            rgb = torch.rand((self.num_cells, 3), generator=gen)
        rgb = torch.as_tensor(rgb, dtype=torch.float32)
        return torch.cat([rgb, torch.ones((self.num_cells, 1), dtype=rgb.dtype, device=rgb.device)], dim=1)

    def params_from_image(self, image_tensor):
        """Mean cell color of an (H, W, 3) [-1, 1] image (box means by integral image)."""
        self._build_geometry()
        img01 = (torch.as_tensor(image_tensor, dtype=torch.float32) + 1.0) / 2.0
        h, w = img01.shape[0], img01.shape[1]
        integral = torch.cumsum(torch.cumsum(img01, dim=0), dim=1)
        integral = torch.nn.functional.pad(integral, (0, 0, 1, 0, 1, 0))
        sx = w / self.canvas_width
        sy = h / self.canvas_height
        boxes = np.array(
            [
                [
                    min(int(np.floor(y1 * sy)), h - 1), min(int(np.floor(x1 * sx)), w - 1),
                    max(min(int(np.ceil(y2 * sy)), h), int(np.floor(y1 * sy)) + 1),
                    max(min(int(np.ceil(x2 * sx)), w), int(np.floor(x1 * sx)) + 1),
                ]
                for (_r, _c, x1, y1, x2, y2) in self._cell_boxes()
            ],
            dtype=np.int64,
        )
        y0, x0, y1, x1 = (torch.from_numpy(boxes[:, i]).to(integral.device) for i in range(4))
        total = integral[y1, x1] - integral[y0, x1] - integral[y1, x0] + integral[y0, x0]
        area = ((y1 - y0) * (x1 - x0)).to(torch.float32)[:, None]
        rgb = total / area
        return torch.cat([rgb, torch.ones((self.num_cells, 1), dtype=rgb.dtype, device=rgb.device)], dim=1)

    def clip_params(self, z):
        alpha_min = 0.0 if self.transparent else 1.0
        return torch.cat([z[:, :3].clamp(0.0, 1.0), z[:, 3:].clamp(alpha_min, 1.0)], dim=1)

    # ------------------------------------------------------------------- render
    def synth(self, model_params, z, iteration=None):
        """(cells, 4) latent → (H, W, 4) canvas in [0, 1]."""
        return composite_cells_separable(
            z, model_params["sep_row_op"], model_params["sep_col_op"], self.num_rows, self.num_cols
        )

    # ------------------------------------------------------------------- export
    def to_svg(self, z) -> str:
        """One ``<polygon>`` per cell, filled with its clipped colour and alpha."""
        self._build_geometry()
        colors = z.detach().float().cpu().numpy()
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{self.canvas_width}" height="{self.canvas_height}" '
            f'viewBox="0 0 {self.canvas_width} {self.canvas_height}">'
        ]
        for poly, rgba in zip(self.polygons, colors):
            pts = " ".join(f"{x:.2f},{y:.2f}" for x, y in poly)
            r, g, b = (np.clip(rgba[:3], 0, 1) * 255).astype(int)
            a = float(np.clip(rgba[3], 0, 1))
            parts.append(f'<polygon points="{pts}" fill="rgb({r},{g},{b})" fill-opacity="{a:.3f}"/>')
        parts.append("</svg>")
        return "\n".join(parts)
