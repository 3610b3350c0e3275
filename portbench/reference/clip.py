"""Plain float32 CLIP towers: OpenAI's ViT image tower and causal text tower.

Written from OpenAI CLIP's ``clip/model.py`` (``VisionTransformer``,
``Transformer``, ``ResidualAttentionBlock``, ``CLIP.encode_text``), with its
state-dict names, so one state dict loads here and into the program under
test.  Attention is spelled out (one matmul for the scores, softmax, one
for the values); every tensor is float32.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names, batch first."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal: bool):
        b, t, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2) for y in (q, k, v))
        scores = q @ k.transpose(-1, -2) / (d // self.heads) ** 0.5
        if causal:
            scores = scores.masked_fill(torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
        out = (scores.softmax(-1) @ v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        h = self.mlp.c_fc(self.ln_2(x))
        return x + self.mlp.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(width, heads) for _ in range(layers))

    def forward(self, x, causal: bool = False):
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class VisionTransformer(nn.Module):
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


class CLIP(nn.Module):
    """The image tower and the text tower under OpenAI's names; ``d`` holds
    the sizes of a configuration file's tower entry."""

    def __init__(self, d: dict):
        super().__init__()
        self.dims = d
        self.visual = VisionTransformer(d)
        self.token_embedding = nn.Embedding(d["vocab_size"], d["text_width"])
        self.positional_embedding = nn.Parameter(torch.empty(d["context_length"], d["text_width"]))
        self.transformer = Transformer(d["text_width"], d["text_layers"], d["text_heads"])
        self.ln_final = nn.LayerNorm(d["text_width"])
        self.text_projection = nn.Parameter(torch.empty(d["text_width"], d["embed_dim"]))

    def encode_image(self, bank, range_grad: bool = True):
        """(N, 3, S, S) cutouts in any range → (N, D) unit embeddings: the
        whole bank stretched to [0, 1] by its own min and max, standardized,
        then the tower.  ``range_grad`` False: the min and max as constants,
        so that no gradient reaches the bank's extremes through them."""
        lo, hi = bank.amin(), bank.amax()
        if not range_grad:
            lo, hi = lo.detach(), hi.detach()
        x = (bank - lo) / (hi - lo)
        mean = torch.tensor(CLIP_MEAN, device=bank.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=bank.device)[:, None, None]
        return F.normalize(self.visual((x - mean) / std), dim=-1)

    def encode_text(self, tokens):
        """(B, T) token ids → (B, D) raw embeddings, pooled at the end-of-text token."""
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        x = self.ln_final(self.transformer(x, causal=True))
        return x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)] @ self.text_projection


def byte_tokens(text: str, context_length: int, vocab_size: int):
    """CLIP's byte-level token ids of a lower-case ASCII word, as the CLIP
    tokenizer gives them without its BPE merge table: start-of-text, one id
    per byte (the byte's place in the printable byte table, the last byte
    in the end-of-word half), end-of-text, zero padding."""
    if not (text.isascii() and text.isalpha() and text.islower()):
        raise ValueError(f"byte_tokens takes one lower-case ASCII word, not {text!r}")
    ids = [ord(c) - ord("!") for c in text[:-1]] + [256 + ord(text[-1]) - ord("!")]
    tokens = [vocab_size - 2] + ids + [vocab_size - 1]
    return tokens + [0] * (context_length - len(tokens))
