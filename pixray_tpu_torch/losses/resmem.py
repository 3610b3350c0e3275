"""ResMem loss: maximize the predicted memorability of the 224-px cutouts
(port of ``pixray_tpu/losses/resmem.py``).

The predictor is the JAX package's: AlexNet's five convolutions at 227²
(after a bilinear resize to 256 and a centre crop), JAX's ``"SAME"``
padding written out per layer (``same_padding``: torch has no
``padding="same"`` for stride 4), then a 9216 → 1024 → 1 head (features
flattened in JAX's (H, W, C) order) and a sigmoid.  The loss is
``0.05 · map_number(mean prediction, 0.4, 1.0, 0, 1) · resmem_weight``.

Weights: random from a seed (the JAX package's scales) with a warning,
unless ``$PIXRAY_TPU_MODELS/resmem_model.pt`` (default ``models/``)
exists; from it the JAX package's best-effort mapping takes the first five
``features`` convolution weights in sorted key order whose shapes fit.
``state_dict_from_flax_resmem`` carries the JAX package's params across.
The network runs in the engine's model dtype (bf16 on the card under
``--precision bf16``, in ``channels_last``); the resize, the
normalization, the sigmoid and the mean are float32.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pixray_tpu_torch.losses.base import LossInterface
from pixray_tpu_torch.utils import map_number

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

ALEXNET_SPEC = [
    # (out_ch, kernel, stride, pool_after)
    (64, 11, 4, True),
    (192, 5, 1, True),
    (384, 3, 1, False),
    (256, 3, 1, False),
    (256, 3, 1, True),
]
HIDDEN = 1024
CROP = (14, 241)  # the 227-px centre crop of the 256-px resize


def same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``"SAME"``: the output is ceil(size / s)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ResMem(nn.Module):
    """images (N, S, S, 3) in [0, 1], float32 → (N,) memorability scores."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        convs = []
        for out_ch, k, s, _pool in ALEXNET_SPEC:
            convs.append(nn.Conv2d(in_ch, out_ch, k, stride=s))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.fc1 = nn.Linear(6 * 6 * 256, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, 1)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)

    @property
    def compute_dtype(self):
        return self.fc1.weight.dtype

    def to_compute_dtype(self, dtype):
        """The weights in ``dtype``; ``channels_last`` convolutions for bf16."""
        self.convs.to(dtype)
        self.fc1.to(dtype)
        self.fc2.to(dtype)
        if dtype == torch.bfloat16:
            self.convs.to(memory_format=torch.channels_last)
        return self

    def features(self, x):
        """(N, 3, 227, 227) normalized → (N, 256, 6, 6) in the compute dtype."""
        h = x.to(self.compute_dtype)
        if h.dtype == torch.bfloat16:
            h = h.contiguous(memory_format=torch.channels_last)
        for conv, (_out, k, s, pool) in zip(self.convs, ALEXNET_SPEC):
            top, bottom = same_padding(h.shape[2], k, s)
            left, right = same_padding(h.shape[3], k, s)
            h = F.relu(conv(F.pad(h, (left, right, top, bottom))))
            if pool:
                h = F.max_pool2d(h, 3, 2)
        return h

    def forward(self, images):
        n = images.shape[0]
        x = images.permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(256, 256), mode="bilinear", align_corners=False, antialias=True)
        x = x[:, :, CROP[0]:CROP[1], CROP[0]:CROP[1]]
        x = (x - self.mean) / self.std
        flat = self.features(x).permute(0, 2, 3, 1).reshape(n, -1)  # JAX's (H, W, C) order
        score = self.fc2(F.relu(self.fc1(flat)))
        return torch.sigmoid(score[:, 0].to(torch.promote_types(score.dtype, torch.float32)))


def init_random_(model: ResMem, gen: torch.Generator) -> ResMem:
    """The JAX package's scales: He-normal kernels, head N(0, 1/fan_in), zero biases, from ``gen``."""
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            conv.bias.zero_()
        for fc in (model.fc1, model.fc2):
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen) * math.sqrt(1.0 / fc.in_features))
            fc.bias.zero_()
    return model


def map_resmem_file(model: ResMem, sd: dict) -> int:
    """The JAX package's best-effort mapping of a ResMem ``.pt`` state
    dict: the first five weights whose key holds "features", in sorted key
    order, each to the convolution of its position when the shapes fit,
    with its bias.  Returns the count mapped."""
    loaded = 0
    alex_keys = [k for k in sd if "features" in k and k.endswith("weight")]
    with torch.no_grad():
        for conv, k in zip(model.convs, sorted(alex_keys)[: len(ALEXNET_SPEC)]):
            w = sd[k].float()
            if w.ndim == 4 and tuple(w.shape) == tuple(conv.weight.shape):
                conv.weight.copy_(w)
                bias_key = k.replace("weight", "bias")
                if bias_key in sd:
                    conv.bias.copy_(sd[bias_key].float())
                loaded += 1
    return loaded


def state_dict_from_flax_resmem(params) -> dict:
    """The JAX package's params ({"alex": {"conv<i>": HWIO kernel, bias},
    "head": {"fc1", "fc2": (in, out) kernel, bias}}) → this module's names."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    out = {}
    for i in range(len(ALEXNET_SPEC)):
        p = params["alex"][f"conv{i}"]
        out[f"convs.{i}.weight"] = t(np.array(p["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        out[f"convs.{i}.bias"] = t(p["bias"])
    for name in ("fc1", "fc2"):
        out[f"{name}.weight"] = t(np.array(params["head"][name]["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = t(params["head"][name]["bias"])
    return out


class ResmemLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--resmem_weight", type=float, help="memorability loss weight", default=1.0, dest="resmem_weight")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        self.model = None

    def place(self, device, dtype, state_dict=None, seed: int = 227):
        """The network, frozen, on ``device`` in ``dtype``: ``state_dict``
        (this module's names), else random from ``seed`` with the
        ``resmem_model.pt`` mapping over it when the file exists."""
        model = ResMem()
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            init_random_(model, torch.Generator().manual_seed(seed))
            path = os.path.join(os.environ.get("PIXRAY_TPU_MODELS", "models"), "resmem_model.pt")
            if os.path.exists(path):
                loaded = map_resmem_file(model, torch.load(path, map_location="cpu"))
                print(f"ResMem: mapped {loaded} conv layers from {path}")
            else:
                print("WARNING: ResMem weights not found (models/resmem_model.pt); using random features")
        self.model = model.requires_grad_(False).eval().to(device).to_compute_dtype(dtype)

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        # the 224-px cutouts (else the smallest size), as the JAX loss scores them
        images = cur_cutouts[224] if 224 in cur_cutouts else cur_cutouts[sorted(cur_cutouts)[0]]
        clipped = torch.minimum(torch.maximum(images, images.new_zeros(())), images.new_ones(()))
        prediction = self.model(clipped)
        return 0.05 * map_number(torch.mean(prediction), 0.4, 1.0, 0, 1) * args.resmem_weight
