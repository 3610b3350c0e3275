"""Perceptor: a frozen CLIP tower with the JAX package's scoring API.

Port of ``pixray_tpu/models/perceptor.py`` for OpenAI ViT perceptors:
``image_fn`` (batch range-stretch + CLIP standardization folded into the
patch embedding, then the tower, then L2 normalization), ``encode_text``
and ``encode_text_with_stops``.  Weights come from a state dict (see
``clip/bridge.py``) or, with none given, from a seeded ``torch.Generator``
with the flax initializers' distributions and a loud warning.
"""

from __future__ import annotations

import hashlib

import torch

from pixray_tpu_torch.ops.grad import l2_normalize

from .clip.configs import CLIP_CONFIGS, CLIP_MEAN, CLIP_STD
from .clip.model import CLIP, init_random_
from .clip.tokenizer import tokenize


def adjust_range_affine(img, out_lo=0.0, out_hi=1.0):
    """Coefficients ``(a, b)`` with ``img * a + b`` stretching the batch to
    [out_lo, out_hi] by its global min/max.  The gradient flows through the
    min and max (split evenly between tied extremes, as in JAX)."""
    minv = torch.amin(img).float()
    span = torch.amax(img).float() - minv
    nonzero = span != 0
    one = torch.ones((), dtype=span.dtype, device=span.device)
    inv = torch.where(nonzero, 1.0 / torch.where(nonzero, span, one), one)
    a = inv * (out_hi - out_lo)
    b = -minv * inv * (out_hi - out_lo) + out_lo
    return a, b


class Perceptor:
    """A frozen scoring model.  ``dtype`` is the tower's compute dtype."""

    def __init__(self, name: str, device="cpu", dtype=torch.float32, state_dict=None):
        if name not in CLIP_CONFIGS:
            raise NotImplementedError(f"perceptor {name!r} is not yet ported to pixray_tpu_torch")
        self.config = CLIP_CONFIGS[name]
        self.name = name
        self.device = torch.device(device)
        self.dtype = dtype
        self.input_resolution = self.config.image_resolution
        self.output_dim = self.config.embed_dim
        self.mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(CLIP_STD, dtype=torch.float32, device=self.device)
        model = CLIP(self.config)
        if state_dict is None:
            print(
                f"WARNING: no checkpoint given for perceptor {name} — initializing "
                "random weights from a seed derived from its name."
            )
            stable = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
            init_random_(model, torch.Generator().manual_seed(stable % (2**31)))
        else:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.model = model.to(device=self.device, dtype=dtype).eval().requires_grad_(False)

    def preprocess_affine(self, imgs):
        """Per-channel (scale, shift) with ``imgs*scale + shift`` = the range
        stretch followed by the CLIP standardization."""
        a, b = adjust_range_affine(imgs)
        return a / self.std, (b - self.mean) / self.std

    def image_fn(self, imgs):
        """(N, 3, S, S) cutouts in [0, 1] → (N, output_dim) L2-normalized embeddings."""
        r = self.input_resolution
        if imgs.shape[2] != r or imgs.shape[3] != r:
            raise ValueError(f"cutouts must be {r}x{r} for {self.name}; got {tuple(imgs.shape)}")
        embeds = self.model.encode_image(imgs, self.preprocess_affine(imgs))
        return l2_normalize(embeds.float(), dim=-1)

    @torch.no_grad()
    def encode_image(self, imgs):
        """(N, S, S, 3) channels-last images in [0, 1] (``io.images.load_image_for_perceptor``
        stacked) → (N, output_dim) L2-normalized embeddings."""
        x = torch.as_tensor(imgs, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
        return self.image_fn(x.contiguous())

    @torch.no_grad()
    def encode_text(self, text):
        """str or list[str] → raw (not normalized) float32 embeddings."""
        tokens = torch.as_tensor(tokenize(text), dtype=torch.long, device=self.device)
        return self.model.encode_text(tokens).float()

    @torch.no_grad()
    def encode_text_with_stops(self, text):
        """'=' prompts: pool at the last content token (one before EOT)."""
        tokens = torch.as_tensor(tokenize(text), dtype=torch.long, device=self.device)
        return self.model.encode_text(tokens, tokens.argmax(dim=-1) - 1).float()
