"""CLIP ViT image tower and causal text tower as ``nn.Module``s.

Port of ``VisionTransformer`` and ``TextTransformer`` in
``pixray_tpu/models/clip/model.py``.  Parameter names are OpenAI CLIP's
state-dict keys (``visual.conv1.weight``, ``transformer.resblocks.0.attn.in_proj_weight``,
...), so ``bridge.py`` maps the JAX package's flax params onto them and an
OpenAI state dict loads without a converter.

Numerics follow the JAX tower's "bf16" rung: every matmul runs in the
module's parameter dtype (bf16 on the card, float32 in the CPU tests), and
attention is plain matmul + softmax with float32 scores.  The patch
embedding is one matmul on channel-major patches (the conv1 weight's own
(c, py, px) row order), with the perceptor's preprocessing affine folded
into the kernel rows as the JAX tower does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import CLIPConfig


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """Packed-qkv attention with ``nn.MultiheadAttention``'s parameter names."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal: bool = False):
        b, t, d = x.shape
        hd = d // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
        if causal:
            mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = _MLP(width)

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x, causal: bool = False):
        for block in self.resblocks:
            x = block(x, causal)
        return x


class _PatchConv(nn.Module):
    """Holds OpenAI's ``conv1.weight`` (width, 3, p, p); applied as a matmul."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))


def patchify_cm(x, p: int):
    """(B, 3, gh*p, gw*p) → (B, gh*gw, 3*p*p) patches in (c, py, px) order."""
    b, c, hgt, wdt = x.shape
    gh, gw = hgt // p, wdt // p
    x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * p * p)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        if cfg.vision_kind != "vit" or cfg.vision_style != "openai":
            raise NotImplementedError(f"perceptor {cfg.name!r}: only OpenAI ViT towers are ported")
        width, p = cfg.vision_width, cfg.vision_patch_size
        self.patch = p
        self.conv1 = _PatchConv(width, p)
        self.class_embedding = nn.Parameter(torch.empty(width))
        n_tok = (cfg.image_resolution // p) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    def forward(self, images, in_affine=None):
        """images: (B, 3, H, W).  ``in_affine`` = per-channel (scale, shift)
        with preprocessed = images*scale + shift, folded into the patch
        embedding (kernel rows scaled, shift as a constant token bias)."""
        p = self.patch
        dtype = self.proj.dtype
        x = patchify_cm(images.to(dtype), p)
        kernel = self.conv1.weight.reshape(self.conv1.weight.shape[0], -1)  # (width, 3pp)
        aff_bias = None
        if in_affine is not None:
            scale, shift = in_affine
            scale_rows = scale.float().repeat_interleave(p * p)
            kernel = (kernel.float() * scale_rows[None, :]).to(dtype)
            aff_bias = torch.einsum(
                "wc,c->w", self.conv1.weight.float().sum(dim=(2, 3)), shift.float())
        x = torch.matmul(x, kernel.t()).float()
        if aff_bias is not None:
            x = x + aff_bias
        x = x.to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return torch.matmul(x, self.proj).float()


class CLIP(nn.Module):
    """ViT image tower + text tower with OpenAI's state-dict layout."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads)
        self.ln_final = nn.LayerNorm(cfg.text_width)
        self.text_projection = nn.Parameter(torch.empty(cfg.text_width, cfg.embed_dim))

    def encode_image(self, images, in_affine=None):
        return self.visual(images, in_affine)

    def encode_text(self, tokens, pool_indices=None):
        """tokens: (B, T) int.  Pools at argmax(tokens) (the EOT id) unless
        ``pool_indices`` are given."""
        dtype = self.text_projection.dtype
        x = self.token_embedding(tokens).to(dtype)
        x = x + self.positional_embedding[: x.shape[1]].to(dtype)
        x = self.transformer(x, causal=True)
        x = self.ln_final(x)
        idx = tokens.argmax(dim=-1) if pool_indices is None else pool_indices
        x = x[torch.arange(x.shape[0], device=x.device), idx]
        return torch.matmul(x, self.text_projection).float()


_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal(shape, std: float, gen):
    """flax ``lecun_normal``-style truncated normal (inverse-CDF draw)."""
    lo, hi = 0.5 * (1 + torch.erf(torch.tensor(-2.0 / 2 ** 0.5))), 0.5 * (1 + torch.erf(torch.tensor(2.0 / 2 ** 0.5)))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return torch.erfinv(2 * u - 1) * (2 ** 0.5) * (std / _TRUNC)


@torch.no_grad()
def init_random_(model: CLIP, gen) -> CLIP:
    """Random weights with the JAX tower's initializer distributions:
    lecun_normal kernels (fan-in), normal(0.02) embeddings and projections,
    normal(0.01) positional tables, unit/zero LayerNorms, zero biases."""
    def lecun(p, fan_in):
        p.copy_(_trunc_normal(p.shape, (1.0 / fan_in) ** 0.5, gen))

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    cfg = model.config
    v = model.visual
    lecun(v.conv1.weight, 3 * cfg.vision_patch_size ** 2)
    normal(v.class_embedding, 0.02)
    normal(v.positional_embedding, 0.01)
    normal(v.proj, 0.02)
    normal(model.token_embedding.weight, 0.02)
    normal(model.positional_embedding, 0.01)
    normal(model.text_projection, 0.02)
    for tower in (v.transformer, model.transformer):
        for blk in tower.resblocks:
            d = blk.attn.out_proj.in_features
            lecun(blk.attn.in_proj_weight, d)
            lecun(blk.attn.out_proj.weight, d)
            lecun(blk.mlp.c_fc.weight, d)
            lecun(blk.mlp.c_proj.weight, 4 * d)
            for b in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                b.zero_()
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
