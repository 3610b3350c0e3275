"""RRDBNet (the Real-ESRGAN 4x generator) and tiled inference (port of
``pixray_tpu/models/esrgan.py``).

23 RRDB blocks of 3 residual-dense blocks each, then two nearest ×2
upsamplings with a conv each.  Submodules carry basicsr's names
(``conv_first``, ``body.<i>.rdb<r>.conv<c>``, ``conv_body``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``), so
``RealESRGAN_x4plus.pth`` (its ``params_ema``) loads as it is;
``state_dict_from_flax_rrdbnet`` is the inverse of the JAX package's
``convert_rrdbnet``.  The convolutions and the activations between them
run in the compute dtype (``to_compute_dtype``: bf16 on the card under
``--precision bf16``), in ``channels_last``; the output comes back as
float32.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _conv(c_in, c_out):
    return nn.Conv2d(c_in, c_out, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.conv1 = _conv(num_feat, num_grow_ch)
        self.conv2 = _conv(num_feat + num_grow_ch, num_grow_ch)
        self.conv3 = _conv(num_feat + 2 * num_grow_ch, num_grow_ch)
        self.conv4 = _conv(num_feat + 3 * num_grow_ch, num_grow_ch)
        self.conv5 = _conv(num_feat + 4 * num_grow_ch, num_feat)

    def forward(self, x):
        lrelu = lambda t: F.leaky_relu(t, 0.2)
        x1 = lrelu(self.conv1(x))
        x2 = lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """x (B, 3, H, W) in [0, 1] → (B, 3, 4H, 4W) float32."""

    def __init__(self, num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.conv_first = _conv(3, num_feat)
        self.body = nn.Sequential(*(RRDB(num_feat, num_grow_ch) for _ in range(num_block)))
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, 3)

    @property
    def compute_dtype(self):
        return self.conv_first.weight.dtype

    def to_compute_dtype(self, dtype):
        """Every convolution in ``dtype`` and ``channels_last`` (cuDNN's NHWC
        kernels, no layout transposes around them)."""
        return self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, x):
        lrelu = lambda t: F.leaky_relu(t, 0.2)
        feat = self.conv_first(x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last))
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
        return self.conv_last(lrelu(self.conv_hr(feat))).float()


def rrdbnet_for(state_dict) -> RRDBNet:
    """An RRDBNet of the widths and depth a basicsr state dict holds."""
    num_feat, _, _, _ = state_dict["conv_first.weight"].shape
    num_grow_ch = state_dict["body.0.rdb1.conv1.weight"].shape[0]
    num_block = 1 + max(int(m.group(1)) for k in state_dict if (m := re.match(r"body\.(\d+)\.", k)))
    return RRDBNet(num_feat=num_feat, num_block=num_block, num_grow_ch=num_grow_ch)


def basicsr_state_dict(ckpt) -> dict:
    """The weights of a basicsr checkpoint (its ``params_ema``, else ``params``, else itself)."""
    if isinstance(ckpt, dict):
        ckpt = ckpt.get("params_ema", ckpt.get("params", ckpt))
    return {k: v for k, v in ckpt.items() if hasattr(v, "shape")}


@torch.no_grad()
def init_random_(model: RRDBNet, gen) -> RRDBNet:
    """Seeded random weights where the model lives: conv weights uniform
    ±1/sqrt(fan_in), biases 0."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.uniform_(-bound, bound, generator=gen)
    return model


def enhance_tiled(model: RRDBNet, img, tile: int = 0, tile_pad: int = 10):
    """Whole-image or overlap-tiled 4x upscale (RealESRGANer.tile_process
    semantics); img and the result (B, H, W, 3), as the JAX function takes them."""
    run = lambda x: model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    if tile <= 0:
        return run(img)
    b, h, w, c = img.shape
    scale = model.scale
    out = torch.zeros((b, h * scale, w * scale, c), dtype=torch.float32, device=img.device)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            py0, px0 = max(y0 - tile_pad, 0), max(x0 - tile_pad, 0)
            py1, px1 = min(y1 + tile_pad, h), min(x1 + tile_pad, w)
            up = run(img[:, py0:py1, px0:px1, :])
            oy0, ox0 = (y0 - py0) * scale, (x0 - px0) * scale
            out[:, y0 * scale:y1 * scale, x0 * scale:x1 * scale, :] = (
                up[:, oy0:oy0 + (y1 - y0) * scale, ox0:ox0 + (x1 - x0) * scale, :])
    return out


def state_dict_from_flax_rrdbnet(params) -> dict:
    """The JAX RRDBNet's ``"params"`` → basicsr names (float32 numpy, HWIO → OIHW)."""
    out = {}

    def walk(prefix, tree):
        for name, sub in tree.items():
            if name == "kernel":
                out[f"{prefix}.weight"] = np.asarray(sub, np.float32).transpose(3, 2, 0, 1)
            elif name == "bias":
                out[f"{prefix}.bias"] = np.asarray(sub, np.float32)
            else:
                walk(f"{prefix}.{name}" if prefix else re.sub(r"^body_(\d+)$", r"body.\1", name), sub)

    walk("", params)
    return out
