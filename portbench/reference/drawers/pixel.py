"""Plain pixel drawer of the rect grid: each cell's RGBA colour, drawn
over transparent black and box-filtered at 2x2 subsamples per pixel; the
colours clamped to [0, 1] and the alpha to 1 after each step (an opaque
canvas).  Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

SUBSAMPLES = 2


def _box_operator(pixels: int, cells: int) -> np.ndarray:
    """(pixels, cells): the share of each pixel's subsamples inside each cell."""
    op = np.zeros((pixels, cells), np.float32)
    for p in range(pixels):
        for k in range(SUBSAMPLES):
            pos = p + (k + 0.5) / SUBSAMPLES
            op[p, min(int(pos * cells / pixels), cells - 1)] += 1.0 / SUBSAMPLES
    return op


class Drawer:
    def __init__(self, settings: dict, weights, device):
        self.width, self.height = settings["size"]
        self.cols, self.rows = settings["pixel_size"]
        self.lr = 0.03  # the pixel drawer's own rate
        self.init_noise = settings.get("init_noise")
        self.row_op = torch.from_numpy(_box_operator(self.height, self.rows)).to(device)
        self.col_op = torch.from_numpy(_box_operator(self.width, self.cols)).to(device)

    def init(self, gen, seed: int):
        if self.init_noise is not None:
            raise NotImplementedError(f"the pixel drawer's reference starts from random colours, not {self.init_noise!r}")
        rgb = torch.rand((self.rows * self.cols, 3), generator=gen)
        return torch.cat([rgb, torch.ones((rgb.shape[0], 1))], 1)

    def synth(self, z):
        """(cells, 4) → (H, W, 3) opaque canvas in [0, 1]."""
        prem = torch.cat([z[:, :3] * z[:, 3:], z[:, 3:]], 1).reshape(self.rows, self.cols, 4)
        return torch.einsum("hr,rck,cw->hwk", self.row_op, prem, self.col_op.T)[..., :3]

    def clip(self, z):
        return torch.cat([z[:, :3].clamp(0.0, 1.0), z[:, 3:].clamp(1.0, 1.0)], 1)


def synth_flops(settings: dict) -> float:
    from portbench.harness.counts import pixel_step_flops

    (width, height), (cols, rows) = settings["size"], settings["pixel_size"]
    return pixel_step_flops(height, width, rows, cols)
