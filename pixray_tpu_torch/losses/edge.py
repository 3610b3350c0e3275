"""Edge loss: pull the canvas margins (or a masked region) toward a colour
or an image (port of ``pixray_tpu/losses/edge.py``).

The target and mask images are opened with PIL at construction (PIL is
imported only when one is given) and resized with PIL's bicubic filter to
the canvas once per canvas size and device.
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.losses.base import LossInterface
from pixray_tpu_torch.utils import get_single_rgb, map_number, real_glob


def _open_image(spec: str, mode: str):
    from PIL import Image

    return Image.open(real_glob(spec)[0]).convert(mode)


def _resized(pil, h: int, w: int) -> torch.Tensor:
    from PIL import Image

    return torch.from_numpy(np.asarray(pil.resize((w, h), Image.BICUBIC), np.float32) / 255.0)


class EdgeLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--edge_thickness", type=int, help="edge thickness all around (percent)", default=5, dest="edge_thickness")
        parser.add_argument("--edge_margins", nargs=4, type=int, help="per-edge thickness (left, right, up, down)", default=None, dest="edge_margins")
        parser.add_argument("--edge_color", type=str, help="color of the edge region", default="white", dest="edge_color")
        parser.add_argument("--edge_color_weight", type=float, help="edge color enforcement", default=0.1, dest="edge_color_weight")
        parser.add_argument("--global_color_weight", type=float, help="global color pull", default=0.05, dest="global_color_weight")
        parser.add_argument("--edge_input_image", type=str, help="target image for the edge region", default="", dest="edge_input_image")
        parser.add_argument("--edge_mask_image", type=str, help="mask selecting the constrained region", default="", dest="edge_mask_image")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        color = settings.edge_color
        self.edge_color = torch.tensor(get_single_rgb(color) if isinstance(color, str) else color,
                                       dtype=torch.float32)
        t = settings.edge_thickness
        self.margins = settings.edge_margins if settings.edge_margins is not None else (t, t, t, t)
        self.target_image_pil = _open_image(settings.edge_input_image, "RGB") if settings.edge_input_image else None
        self.mask_pil = _open_image(settings.edge_mask_image, "L") if settings.edge_mask_image else None

    def _targets(self, out):
        h, w = out.shape[0], out.shape[1]
        if self.target_image_pil is not None:
            target = self.constant(("target", h, w), out.device, lambda: _resized(self.target_image_pil, h, w))
        else:
            target = self.constant("color", out.device, lambda: self.edge_color).expand(out.shape)
        mask = None
        if self.mask_pil is not None:
            mask = self.constant(("mask", h, w), out.device, lambda: _resized(self.mask_pil, h, w)[..., None])
        return target, mask

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        target, mask = self._targets(out)
        h, w = out.shape[0], out.shape[1]
        loss = out.new_zeros(())
        if mask is None:
            left, right, upper, lower = self.margins
            left = int(map_number(left, 0, 100, 0, w))
            right = int(map_number(right, 0, 100, 0, w))
            upper = int(map_number(upper, 0, 100, 0, h))
            lower = int(map_number(lower, 0, 100, 0, h))
            if left != 0:
                loss = loss + torch.mean((out[:, :left] - target[:, :left]) ** 2)
            if right != 0:
                loss = loss + torch.mean((out[:, w - right :] - target[:, w - right :]) ** 2)
            if upper != 0:
                loss = loss + torch.mean(
                    (out[:upper, left : w - right] - target[:upper, left : w - right]) ** 2
                )
            if lower != 0:
                loss = loss + torch.mean(
                    (out[h - lower :, left : w - right] - target[h - lower :, left : w - right]) ** 2
                )
        else:
            masked_out = torch.where(mask > 0, target, out)
            loss = loss + torch.mean((masked_out - target) ** 2)
        if args.global_color_weight:
            loss = loss + torch.mean((out - target) ** 2) * args.global_color_weight
        return loss * args.edge_color_weight
