"""VQGAN (taming-transformers VQModel / GumbelVQ) in PyTorch, NCHW (port of
``pixray_tpu/models/vqgan.py``).

    encode: image [-1, 1] → encoder → quant_conv → nearest-code quantize
    decode: latent → post_quant_conv → decoder → image [-1, 1]

Submodules carry taming's state-dict names (``encoder.down.{i}.block.{j}``,
``decoder.up.{i}.attn.{j}``, ``decoder.mid.block_1``, ``quant_conv``,
``quantize.embedding.weight``; ``quantize.embed.weight`` for the Gumbel
model), so a taming checkpoint loads with ``load_state_dict`` once the keys
this model does not have (taming's loss and Gumbel ``proj`` weights, which
the JAX converter skips too) are dropped.  ``state_dict_from_flax_vqgan``
is the inverse of the JAX package's ``convert_taming_vqgan``.

Precision (``to_compute_dtype``): the encoder's and decoder's convolutions
and the attention's probabilities × values run in the compute dtype (bf16 on
the card under ``--precision bf16``: the JAX model is f32, but XLA runs f32
convolutions on the TPU as one bf16 pass).  GroupNorm statistics, the
attention scores (bf16-rounded q and k multiplied in f32) and the softmax
stay f32.  ``quant_conv``, ``post_quant_conv`` and ``quantize`` are always
f32, and the code distance is an exact f32 product (no TF32): the random
codebook is ~1.2e-4 wide per dim at 16384 codes, where a bf16 or TF32
distance picks other codes.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip.model import _trunc_normal


@dataclass(frozen=True)
class VQGANConfig:
    ch: int = 128
    ch_mult: tuple = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    resolution: int = 256
    z_channels: int = 256
    embed_dim: int = 256
    n_embed: int = 16384
    gumbel: bool = False

    @property
    def num_resolutions(self):
        return len(self.ch_mult)


VQGAN_CONFIGS = {
    # tiny model for CI/e2e tests (random weights; CPU-fast; f4)
    "tiny_test": VQGANConfig(
        ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
        resolution=32, z_channels=32, embed_dim=32, n_embed=64,
    ),
    "imagenet_f16_1024": VQGANConfig(n_embed=1024),
    "imagenet_f16_16384": VQGANConfig(n_embed=16384),
    "imagenet_f16_16384m": VQGANConfig(n_embed=16384),
    "coco": VQGANConfig(n_embed=8192),
    "faceshq": VQGANConfig(n_embed=1024),
    "wikiart_1024": VQGANConfig(n_embed=1024),
    "wikiart_1024m": VQGANConfig(n_embed=1024),
    "wikiart_16384": VQGANConfig(n_embed=16384),
    "wikiart_16384m": VQGANConfig(n_embed=16384),
    "wikiart_16384m2": VQGANConfig(n_embed=16384),
    "sflckr": VQGANConfig(n_embed=1024),
    "openimages_f16_8192": VQGANConfig(
        ch_mult=(1, 1, 2, 2, 4), n_embed=8192, gumbel=True
    ),
}


def swish(x):
    return x * torch.sigmoid(x)


class GroupNorm(nn.GroupNorm):
    """32 groups, eps 1e-6; statistics and affine in f32 whatever the
    activations' dtype (flax computes the variance as E[x²] − E[x]², torch
    in two passes: the two agree to f32 rounding of the statistics)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        # only where the channel count changes, as in taming and the JAX model
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention, scores scaled by c ** -0.5."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, c, h * w) for m in (self.q, self.k, self.v))
        # f32 scores of the compute-dtype q and k (the TPU's bf16-in/f32-out
        # product; bf16 values are exact in f32 and TF32 alike)
        scores = torch.matmul(q.float().transpose(1, 2), k.float()) * (c ** -0.5)  # (b, q, k)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Pad bottom/right by one, then a stride-2 VALID 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2 (``jax.image.resize(..., "nearest")`` at an exact 2×), then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _level() -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList()
    level.attn = nn.ModuleList()
    return level


def _mid(c: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(c, c)
    mid.attn_1 = AttnBlock(c)
    mid.block_2 = ResnetBlock(c, c)
    return mid


def _run_mid(mid, h):
    return mid.block_2(mid.attn_1(mid.block_1(h)))


def _run_blocks(level, h):
    """A level's resnet blocks, each followed by its attention block if the level has them."""
    for j, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[j](h)
    return h


class Encoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(3, cfg.ch, 3, padding=1)
        cur_res = cfg.resolution
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, cfg.ch * mult))
                block_in = cfg.ch * mult
                # placed by the config's resolution, not by the canvas
                if cur_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i != cfg.num_resolutions - 1:
                level.downsample = Downsample(block_in)
                cur_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _run_blocks(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """taming builds ``up`` from the deepest level down and indexes it by
    level: ``up[i]`` is level i, run from i = num_resolutions - 1 to 0."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        cur_res = cfg.resolution // (2 ** (cfg.num_resolutions - 1))
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _mid(block_in)
        levels = {}
        for i in reversed(range(cfg.num_resolutions)):
            level = _level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, cfg.ch * cfg.ch_mult[i]))
                block_in = cfg.ch * cfg.ch_mult[i]
                if cur_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i != 0:
                level.upsample = Upsample(block_in)
                cur_res *= 2
            levels[i] = level
        self.up = nn.ModuleList(levels[i] for i in range(cfg.num_resolutions))
        self.norm_out = GroupNorm(block_in)
        self.conv_out = nn.Conv2d(block_in, 3, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid, self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            h = _run_blocks(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantization with a straight-through gradient, in
    exact f32.  The table is ``embedding`` (VQModel) or ``embed`` (GumbelVQ)."""

    def __init__(self, n_embed: int, embed_dim: int, gumbel: bool = False):
        super().__init__()
        self.table = "embed" if gumbel else "embedding"
        setattr(self, self.table, nn.Embedding(n_embed, embed_dim))

    @property
    def codebook(self):
        return getattr(self, self.table).weight

    def nearest(self, flat):
        """(M, C) f32 → (M,) index of the nearest code (first on ties, as ``jnp.argmin``)."""
        cb = self.codebook.float()
        with _no_tf32():
            cross = flat @ cb.T
        d = torch.sum(flat ** 2, dim=1, keepdim=True) - 2.0 * cross + torch.sum(cb ** 2, dim=1)[None, :]
        return torch.argmin(d, dim=1)

    def forward(self, z):
        """(B, C, H, W) → the same shape in f32, every vector a codebook row."""
        z = z.float()
        b, c, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, c)
        idx = self.nearest(flat.detach())
        z_q = self.codebook.float()[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
        return z + (z_q - z).detach()


class VQGAN(nn.Module):
    """encode: image [-1, 1] (B, 3, H, W) → quantized latent; decode: latent → image [-1, 1]."""

    def __init__(self, config: VQGANConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(config.z_channels, config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim, config.z_channels, 1)
        self.quantize = VectorQuantizer(config.n_embed, config.embed_dim, config.gumbel)

    @property
    def compute_dtype(self):
        return self.encoder.conv_in.weight.dtype

    def to_compute_dtype(self, dtype):
        """Encoder and decoder convolutions in ``dtype``; GroupNorms, the
        1x1 quant convs and the codebook stay f32."""
        self.encoder.to(dtype)
        self.decoder.to(dtype)
        for m in self.modules():
            if isinstance(m, GroupNorm):
                m.float()
        return self

    def encode(self, x):
        h = self.encoder(x.to(self.compute_dtype)).float()
        return self.quantize(self.quant_conv(h))

    def decode(self, z_q):
        return self.decoder(self.post_quant_conv(z_q).to(self.compute_dtype)).float()

    def decode_from_continuous(self, z):
        return self.decode(self.quantize(z))


@torch.no_grad()
def init_random_(model: VQGAN, gen) -> VQGAN:
    """The flax initializers' distributions: lecun_normal conv kernels
    (truncated normal, fan-in), zero biases, unit GroupNorm scales, and the
    codebook uniform on [0, 2 / n_embed) (``nn.initializers.uniform``)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(_trunc_normal(m.weight.shape, (1.0 / fan_in) ** 0.5, gen))
            m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    cb = model.quantize.codebook
    cb.copy_(torch.rand(cb.shape, generator=gen) * (2.0 / model.config.n_embed))
    return model


def load_taming_state_dict(model: VQGAN, state_dict) -> VQGAN:
    """Load a taming checkpoint's ``state_dict``: keys this model does not
    have are dropped, a missing key raises."""
    own = model.state_dict()
    model.load_state_dict({k: torch.tensor(v, dtype=torch.float32) if isinstance(v, np.ndarray) else v.float()
                           for k, v in state_dict.items() if k in own})
    return model


# ---------------------------------------------------------------------------
# flax params → taming state dict (the inverse of convert_taming_vqgan)
# ---------------------------------------------------------------------------

_RENAMES = (
    (re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$"), r"\1.\2.\3.\4"),
    (re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$"), r"\1.\2.\3"),
    (re.compile(r"^mid_(block_1|attn_1|block_2)$"), r"mid.\1"),
)


def _torch_name(flax_name: str) -> str:
    for pattern, repl in _RENAMES:
        if pattern.match(flax_name):
            return pattern.sub(repl, flax_name)
    return flax_name


def _walk(out: dict, prefix: str, tree) -> None:
    for name, sub in tree.items():
        if name == "kernel":  # flax (kh, kw, in, out) → torch (out, in, kh, kw)
            out[f"{prefix}.weight"] = np.asarray(sub, np.float32).transpose(3, 2, 0, 1)
        elif name == "scale":
            out[f"{prefix}.weight"] = np.asarray(sub, np.float32)
        elif name == "bias":
            out[f"{prefix}.bias"] = np.asarray(sub, np.float32)
        else:
            _walk(out, f"{prefix}.{_torch_name(name)}", sub)


def state_dict_from_flax_vqgan(params, config: VQGANConfig) -> dict:
    """``params`` = the JAX VQGAN's ``"params"`` collection → taming-named
    float32 numpy arrays (renames and transposes only)."""
    out: dict = {}
    for name, sub in params.items():
        if name == "codebook":
            table = "embed" if config.gumbel else "embedding"
            out[f"quantize.{table}.weight"] = np.asarray(sub, np.float32)
        else:
            _walk(out, name, sub)
    return out
