"""Plain float32 CLIP: an image tower of the configuration's kind
(``reference/towers/``) and OpenAI's causal text tower.

Written from OpenAI CLIP's ``clip/model.py`` (``Transformer``,
``ResidualAttentionBlock``, ``CLIP.encode_text``), with its state-dict
names, so one state dict loads here and into the program under test.
Attention is spelled out (one matmul for the scores, softmax, one for the
values); every tensor is float32.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from portbench.reference import towers

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


def block_rule(name: str, shape):
    """The initialiser of a residual attention block's tensor (``name``
    ending in the block's own names), or None for another tensor."""
    if name.endswith(("ln_1.weight", "ln_2.weight")):
        return ("ones",)
    if name.endswith("bias"):
        return ("zeros",)
    if name.endswith(("in_proj_weight", "out_proj.weight", "c_fc.weight", "c_proj.weight")):
        return ("normal", shape[1] ** -0.5)
    return None


def text_rule(name: str, shape, d: dict):
    """The initialiser of a text tower's tensor (a name outside ``visual.``)."""
    if name == "ln_final.weight":
        return ("ones",)
    if name == "positional_embedding":
        return ("normal", 0.01)
    if name in ("token_embedding.weight", "text_projection"):
        return ("normal", 0.02)
    rule = block_rule(name, shape)
    if rule is None:
        raise KeyError(f"no initialiser for CLIP tensor {name}")
    return rule


def init_rule(name: str, shape, d: dict, bench_dir: str | None = None):
    """The initialiser of one tensor of ``CLIP(d)``: the image tower's kind's
    rule below ``visual.``, the text tower's elsewhere."""
    if name.startswith("visual."):
        return towers.module(towers.kind_of(d), bench_dir).init_rule(name[len("visual."):], shape, d)
    return text_rule(name, shape, d)


class CLIP(nn.Module):
    """The image tower and the text tower under OpenAI's names; ``d`` holds
    the sizes of a configuration file's tower entry, the image tower's kind
    among them (``reference/towers/``; ``bench_dir``: the benchmark folder
    whose kinds come first)."""

    def __init__(self, d: dict, bench_dir: str | None = None):
        super().__init__()
        self.dims = d
        self.visual = towers.module(towers.kind_of(d), bench_dir).Visual(d)
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
