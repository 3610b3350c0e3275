"""OpenAI CLIP's ``VisionTransformer`` image tower, plain float32.

Written from OpenAI CLIP's ``clip/model.py``: a patch convolution, the
class token and positional table, ``ln_pre``, the residual attention
blocks (``reference/clip.py``'s ``Transformer``), ``ln_post`` on the class
token and the projection.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.clip import Transformer, block_rule


class Visual(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        width, patch, res = d["vision_width"], d["vision_patch_size"], d["image_resolution"]
        self.patch = patch
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty((res // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, d["vision_layers"], d["vision_heads"])
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, d["embed_dim"]))

    def forward(self, x):
        x = self.conv1(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


def init_rule(name: str, shape, d: dict):
    """The initialiser of the tensor ``visual.<name>``."""
    if name in ("ln_pre.weight", "ln_post.weight"):
        return ("ones",)
    if name == "conv1.weight":
        return ("normal", (3 * d["vision_patch_size"] ** 2) ** -0.5)
    if name == "positional_embedding":
        return ("normal", 0.01)
    if name in ("class_embedding", "proj"):
        return ("normal", 0.02)
    rule = block_rule(name, shape)
    if rule is None:
        raise KeyError(f"no initialiser for ViT tensor visual.{name}")
    return rule


def image_flops(d: dict) -> dict:
    """One image through the tower: {"linear": the patch embedding, the
    blocks' dense layers and the projection, "attention": the score and
    value products}."""
    w, p, res = d["vision_width"], d["vision_patch_size"], d["image_resolution"]
    grid = (res // p) ** 2
    t = grid + 1
    linear = 2 * grid * 3 * p * p * w + d["vision_layers"] * 24 * t * w * w + 2 * w * d["embed_dim"]
    attention = d["vision_layers"] * 4 * t * t * w
    return {"linear": linear, "attention": attention}
