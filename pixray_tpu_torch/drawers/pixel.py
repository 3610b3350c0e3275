"""Pixel drawer: trainable RGBA fills of a cell grid (port of ``pixray_tpu/drawers/pixel.py``).

Grid sizing (with the iso and edge checks), the six cell geometries
(rect, rectshift, hex, tri, diamond, knit), latent init, image encoding
and the post-step clamp follow the JAX drawer.  The geometry is
rasterized once into a coverage map (``ops/cellrender.py``); the rect grid
renders as two matmuls (``composite_cells_separable``), every other
geometry as the gather-and-composite ``composite_cells`` with the static
inverse map as its adjoint.  The maps are fixed inputs of the step, moved
to the device once.  ``to_svg`` writes one polygon per cell, as the JAX
drawer does.
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.ops.cellrender import (
    build_coverage_map,
    build_inverse_map,
    composite_cells,
    composite_cells_separable,
    try_separable_operators,
)
from pixray_tpu_torch.utils import map_number, str2bool

SHIFT_PIXEL_TYPES = ["hex", "rectshift", "diamond"]


def rect_from_corners(p0, p1):
    x1, y1 = p0
    x2, y2 = p1
    return [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]


def diamond_from_corners(p0, p1):
    x1, y1 = p0
    x2, y2 = p1
    hy_a = map_number(-2, -1, 1, y1, y2)
    hy_b = map_number(2, -1, 1, y1, y2)
    hy_h = map_number(0, -1, 1, y1, y2)
    hx_h = map_number(0, -1, 1, x1, x2)
    return [[hx_h, hy_a], [x1, hy_h], [hx_h, hy_b], [x2, hy_h]]


def tri_from_corners(p0, p1, is_up):
    x1, y1 = p0
    x2, y2 = p1
    hx_a = map_number(2, -1, 1, x1, x2)
    hx_b = map_number(-2, -1, 1, x1, x2)
    hx_h = map_number(0, -1, 1, x1, x2)
    if is_up:
        return [[hx_h, y1], [hx_b, y2], [hx_a, y2]]
    return [[hx_h, y2], [hx_a, y1], [hx_b, y1]]


def hex_from_corners(p0, p1):
    x1, y1 = p0
    x2, y2 = p1
    n = 3
    hy_a = map_number(4, -n, n, y1, y2)
    hy_b = map_number(2, -n, n, y1, y2)
    hy_c = map_number(-2, -n, n, y1, y2)
    hy_d = map_number(-4, -n, n, y1, y2)
    hx_h = map_number(0, -n, n, x1, x2)
    return [[hx_h, hy_a], [x1, hy_b], [x1, hy_c], [hx_h, hy_d], [x2, hy_c], [x2, hy_b]]


def knit_from_corners(p0, p1):
    x1, y1 = p0
    x2, y2 = p1
    xm = (x1 + x2) / 2.0
    lean_up, slump_down, fall_back = 0.45, 0.30, 0.2
    y_up1 = map_number(lean_up, 0, 1, y2, y1)
    y_up2 = map_number(1 + lean_up, 0, 1, y2, y1)
    y_down1 = map_number(slump_down, 0, 1, y1, y2)
    y_down2 = map_number(1 + slump_down, 0, 1, y1, y2)
    x_fb1 = map_number(fall_back, 0, 1, x2, xm)
    x_fb2 = map_number(fall_back, 0, 1, x1, xm)
    return [
        [xm, y_down2], [x2, y_up1], [x2, y_up2], [x_fb1, y_up2],
        [xm, y_down1], [x_fb2, y_up2], [x1, y_up2], [x1, y_up1],
    ]


class PixelDrawer:
    has_alpha = True
    learning_rate = 0.03  # the engine divides it on LR drops

    @staticmethod
    def add_settings(parser):
        parser.add_argument("--pixel_size", nargs=2, type=int, help="Pixel size (width height)", default=None, dest="pixel_size")
        parser.add_argument("--pixel_scale", type=float, help="Pixel scale", default=None, dest="pixel_scale")
        parser.add_argument("--pixel_type", type=str, help="rect, rectshift, hex, tri, diamond, knit", default="rect", dest="pixel_type")
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

        if settings.pixel_iso_check and settings.pixel_size is None:
            if self.pixel_type == "tri":
                self.num_cols = int(1.414 * self.num_cols)
            elif self.pixel_type == "hex":
                self.num_rows = int(1.414 * self.num_rows)
            elif self.pixel_type == "diamond":
                self.num_rows = int(2 * self.num_rows)

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

        if settings.pixel_edge_check:
            if self.pixel_type in SHIFT_PIXEL_TYPES:
                if self.num_cols % 2 == 0:
                    self.num_cols += 1
                if self.num_rows % 2 == 0:
                    self.num_rows += 1
            elif self.pixel_type == "tri":
                if self.num_cols % 2 == 0:
                    self.num_cols += 1
                if self.num_rows % 2 == 1:
                    self.num_rows += 1

        self.transparent = settings.transparent
        self.model_params = None

    # ------------------------------------------------------------------ geometry
    def _cell_boxes(self):
        """Per-cell (row, col, x0, y0, x1, y1) boxes in draw order; the
        shifted geometries' even rows hold one cell fewer, offset by half a
        cell."""
        cw = self.canvas_width / self.num_cols
        ch = self.canvas_height / self.num_rows
        cells = []
        for r in range(self.num_rows):
            cur_y = r * ch
            num_cols_this_row = self.num_cols
            col_offset = 0.0
            if self.pixel_type in SHIFT_PIXEL_TYPES and r % 2 == 0:
                num_cols_this_row = self.num_cols - 1
                col_offset = 0.5
            for c in range(num_cols_this_row):
                cur_x = (col_offset + c) * cw
                cells.append((r, c, cur_x, cur_y, cur_x + cw, cur_y + ch))
        return cells

    def _polygon(self, r, c, x1, y1, x2, y2):
        p0, p1 = [x1, y1], [x2, y2]
        if self.pixel_type == "hex":
            return hex_from_corners(p0, p1)
        if self.pixel_type == "tri":
            return tri_from_corners(p0, p1, (r + c) % 2 == 0)
        if self.pixel_type == "diamond":
            return diamond_from_corners(p0, p1)
        if self.pixel_type == "knit":
            return knit_from_corners(p0, p1)
        return rect_from_corners(p0, p1)

    def _build_geometry(self):
        if self.model_params is not None:
            return
        self.polygons = [np.asarray(self._polygon(*cell), dtype=np.float64) for cell in self._cell_boxes()]
        self.num_cells = len(self.polygons)
        indices, valid = build_coverage_map(self.polygons, self.canvas_width, self.canvas_height)
        sep = try_separable_operators(indices, valid, self.num_rows, self.num_cols)
        if sep is not None:
            # the rect grid: the map factorizes, the render is two matmuls
            self.model_params = {
                "sep_row_op": torch.from_numpy(sep[0]),
                "sep_col_op": torch.from_numpy(sep[1]),
            }
            return
        cell_slots, cell_valid = build_inverse_map(indices, valid, self.num_cells)
        # int64 indices: the step's gathers take them as they are
        self.model_params = {
            "coverage_indices": torch.from_numpy(indices.astype(np.int64)),
            "coverage_valid": torch.from_numpy(valid),
            "cell_slots": torch.from_numpy(cell_slots.astype(np.int64)),
            "cell_slot_valid": torch.from_numpy(cell_valid),
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
        if "sep_row_op" in model_params:
            return composite_cells_separable(
                z, model_params["sep_row_op"], model_params["sep_col_op"], self.num_rows, self.num_cols
            )
        return composite_cells(
            z, model_params["coverage_indices"], model_params["coverage_valid"], self.canvas_height,
            self.canvas_width, inverse_map=(model_params["cell_slots"], model_params["cell_slot_valid"]),
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
