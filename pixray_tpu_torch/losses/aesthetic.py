"""Aesthetic loss: a linear rating head on the step's CLIP embeddings (port
of ``pixray_tpu/losses/aesthetic.py``).

The 512 → 1 head (trained on AVA ratings of ViT-B/16 embeddings) reads
``globals["embeds"]``, the last perceptor's embeddings, rather than
encoding again.  Its weights load from
``$PIXRAY_TPU_MODELS/ava_vit_b_16_linear.pth`` (default ``models/``) when
the file exists; otherwise the head is zero, with a warning, and the loss
is inert.  Nothing is downloaded.
"""

from __future__ import annotations

import os

import torch

from pixray_tpu_torch.losses.base import LossInterface
from pixray_tpu_torch.ops.grad import l2_normalize


class AestheticLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--aesthetic_target", type=float, help="0-10", default=10, dest="aesthetic_target")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        path = os.path.join(os.environ.get("PIXRAY_TPU_MODELS", "models"), "ava_vit_b_16_linear.pth")
        if os.path.exists(path):
            layer_weights = torch.load(path, map_location="cpu")
            self.weight = layer_weights["weight"].float()  # (1, 512)
            self.bias = layer_weights["bias"].float()  # (1,)
        else:
            print("WARNING: aesthetic head weights not found (models/ava_vit_b_16_linear.pth); using zeros")
            self.weight = torch.zeros((1, 512), dtype=torch.float32)
            self.bias = torch.zeros((1,), dtype=torch.float32)

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        embeds = globals["embeds"].float()  # (N, D) from the engine's last perceptor
        if embeds.shape[-1] != self.weight.shape[1]:
            # the head is dimension-specific (ViT-B/16): inert on a mismatch
            return embeds.new_zeros(())
        weight = self.constant("weight", embeds.device, lambda: self.weight)
        bias = self.constant("bias", embeds.device, lambda: self.bias)
        rating = l2_normalize(embeds, dim=-1) @ weight.T + bias  # (N, 1)
        return torch.mean(torch.square(rating - args.aesthetic_target)) * 0.02
