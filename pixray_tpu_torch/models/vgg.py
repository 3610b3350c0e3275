"""VGG16 feature tower for the STROTSS style loss (port of ``pixray_tpu/models/vgg.py``).

``VGG16Features.features`` is torchvision's ``vgg16().features`` layout
(convolutions at ``features.{0,2,5,7,10,12,14,17,19,21,24,26,28}``, max
pools before convolutions 2, 4, 7 and 10), so a torchvision state dict
loads as it is.  The captured maps are the ReLU outputs of convolutions
``CAPTURE_CONVS`` (torchvision indices 1, 3, 6, 8, 11, 13, 15, 22, 29),
after the normalized input: the 3 + 2·64 + 2·128 + 3·256 + 2·512-channel
hypercolumn of STROTSS.

Weights come from ``vgg16.pth``, ``vgg16_features.pth`` or
``vgg16-397923af.pth`` under ``$PIXRAY_TPU_MODELS`` (default ``models/``),
as the JAX package searches; otherwise they are random from a seed, with a
warning.  Nothing is downloaded.  ``state_dict_from_flax_vgg16`` carries
the JAX package's params across (HWIO → OIHW).

Precision, as the port's other convolutional models: the convolutions,
ReLUs and pools run in the compute dtype (``to_compute_dtype``: bf16 in
``channels_last`` on the card under ``--precision bf16``, float32 under
``fp32`` and on the CPU); the input's normalization is float32, and the
captured maps come back in the compute dtype.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_channels, pool_before) per convolution in torchvision order
VGG16_CONVS = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# torchvision's feature indices [1,3,6,8,11,13,15,22,29] are the ReLUs of convolutions 0-6, 9 and 12
CAPTURE_CONVS = {0, 1, 2, 3, 4, 5, 6, 9, 12}
FEATURE_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
WEIGHT_FILES = ("vgg16.pth", "vgg16_features.pth", "vgg16-397923af.pth")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """x (B, 3, H, W) float32 → the captured maps: [the normalized input
    (float32), then nine (B, C, H', W') ReLU outputs in the compute dtype]."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for out_ch, pool in VGG16_CONVS:
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU()]
            in_ch = out_ch
        layers.append(nn.MaxPool2d(2, 2))  # torchvision's last pool (index 30), never run
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)

    @property
    def convs(self):
        return [self.features[i] for i in FEATURE_INDICES]

    @property
    def compute_dtype(self):
        return self.features[0].weight.dtype

    def to_compute_dtype(self, dtype):
        """The convolutions in ``dtype``; ``channels_last`` for bf16 (cuDNN's NHWC kernels)."""
        self.features.to(dtype)
        if dtype == torch.bfloat16:
            self.features.to(memory_format=torch.channels_last)
        return self

    def forward(self, x, space: str = "uniform"):
        if space != "vgg":
            x = (x + 1.0) / 2.0
            x = (x - self.mean) / self.std
        feats = [x]
        dtype = self.compute_dtype
        h = x.to(dtype)
        if dtype == torch.bfloat16:
            h = h.contiguous(memory_format=torch.channels_last)
        for i, ((_out, pool), conv) in enumerate(zip(VGG16_CONVS, self.convs)):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(conv(h))
            if i in CAPTURE_CONVS:
                feats.append(h)
        return feats


def init_random_(model: VGG16Features, gen: torch.Generator) -> VGG16Features:
    """He-normal kernels (the JAX package's ``init_vgg16_params`` scale) and zero biases, from ``gen``."""
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * 9
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            conv.bias.zero_()
    return model


def load_vgg16(device="cuda", dtype=torch.float32, state_dict=None, seed: int = 16) -> VGG16Features:
    """The frozen tower on ``device`` (the card unless the caller asks for
    the CPU) in ``dtype``: from ``state_dict``
    (torchvision names), else from the first weight file found, else random
    from ``seed`` with a warning."""
    model = VGG16Features()
    if state_dict is None:
        root = os.environ.get("PIXRAY_TPU_MODELS", "models")
        for name in WEIGHT_FILES:
            path = os.path.join(root, name)
            if os.path.exists(path):
                state_dict = torch.load(path, map_location="cpu")
                print(f"Loaded VGG16 weights from {path}")
                break
    if state_dict is None:
        print("WARNING: VGG16 weights not found under models/ — using random init")
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        feats = {k: v for k, v in state_dict.items() if k.startswith("features.")}
        model.load_state_dict(feats)
    model.requires_grad_(False).eval()
    return model.to(device).to_compute_dtype(dtype)


def state_dict_from_flax_vgg16(params) -> dict:
    """The JAX package's VGG16 params ({"conv<i>": {"kernel" HWIO, "bias"}})
    → torchvision names (OIHW)."""
    out = {}
    for i, fi in enumerate(FEATURE_INDICES):
        p = params[f"conv{i}"]
        out[f"features.{fi}.weight"] = torch.from_numpy(np.array(p["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        out[f"features.{fi}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return out
