"""Colour-lookup filter: a nearest-palette snap with straight-through
gradients and a commitment loss (port of ``pixray_tpu/filters/lookup.py``).

The nearest colour is the first index of the least |p|² − 2p·c + |c|²
(the JAX filter's expanded form, not ``torch.cdist``); the alpha channel
passes through.  The colour table reaches the device once.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.filters.base import FilterInterface

DEFAULT_COLOR_TABLE = [
    [0, 0, 0], [255, 255, 255], [63, 40, 50], [38, 43, 68],
    [90, 105, 136], [139, 155, 180], [25, 60, 62], [38, 92, 66],
    [62, 137, 72], [99, 199, 77], [254, 231, 97], [254, 174, 52],
    [254, 174, 52], [247, 118, 34], [184, 111, 80], [116, 63, 57],
]


def nearest_colors(flat, table):
    """Index of the nearest row of ``table`` (K, 3) for each row of ``flat``
    (M, 3), by the expanded squared distance; ties take the first index."""
    d2 = (torch.sum(flat**2, dim=1, keepdim=True) - 2.0 * flat @ table.T
          + torch.sum(table**2, dim=1)[None, :])
    return torch.argmin(d2, dim=-1)


class ColorLookup(FilterInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--lookup_beta", type=float, help="loss scaling", default=10.0, dest="lookup_beta")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        self.beta = settings.lookup_beta
        table = settings.palette
        if table is None:
            print("WARNING: using built in palette")
            table = [[c / 255.0 for c in rgb] for rgb in DEFAULT_COLOR_TABLE]
        print(f"color table has {len(table)} entries like {table[0:5]}")
        self.color_table = torch.tensor(table, dtype=torch.float32)  # (K, 3)

    def __call__(self, img, draws):
        table = self.constant("color_table", img.device, lambda: self.color_table)
        z3 = img[..., :3]
        z_q = table[nearest_colors(z3.reshape(-1, 3), table)].reshape(z3.shape)
        loss = self.beta * torch.mean((z_q.detach() - z3) ** 2) + torch.mean((z_q - z3.detach()) ** 2)
        z_q = z3 + (z_q - z3).detach()  # straight-through estimator
        out = torch.cat([z_q, img[..., 3:]], dim=-1) if img.shape[-1] == 4 else z_q
        return out, loss
