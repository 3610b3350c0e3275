"""Plain float32 VQGAN (taming-transformers ``VQModel``), NCHW, under
taming's state-dict names.

Written from taming's ``diffusionmodules/model.py`` (``Encoder``,
``Decoder``, ``ResnetBlock``, ``AttnBlock``, ``Upsample``, ``Downsample``)
and ``vqvae/quantize.py`` (nearest-code quantization with the
straight-through gradient).  Every tensor is float32; the code distance is
an exact float32 product.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def swish(x):
    return x * torch.sigmoid(x)


def norm(c: int):
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(swish(self.norm2(self.conv1(swish(self.norm1(x))))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = norm(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, c, h * w) for m in (self.q, self.k, self.v))
        attn = torch.softmax(q.transpose(1, 2) @ k * c ** -0.5, dim=-1)  # (b, query, key)
        return x + self.proj_out((v @ attn.transpose(1, 2)).reshape(b, c, h, w))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _level():
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(), nn.ModuleList()
    return level


def _mid(c: int):
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = ResnetBlock(c, c), AttnBlock(c), ResnetBlock(c, c)
    return mid


def _blocks(level, h):
    for j, blk in enumerate(level.block):
        h = blk(h)
        if len(level.attn):
            h = level.attn[j](h)
    return h


class Encoder(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        ch, mult = d["ch"], d["ch_mult"]
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        res, cin = d["resolution"], ch
        self.down = nn.ModuleList()
        for i, m in enumerate(mult):
            level = _level()
            for _ in range(d["num_res_blocks"]):
                level.block.append(ResnetBlock(cin, ch * m))
                cin = ch * m
                if res in d["attn_resolutions"]:
                    level.attn.append(AttnBlock(cin))
            if i != len(mult) - 1:
                level.downsample = Downsample(cin)
                res //= 2
            self.down.append(level)
        self.mid = _mid(cin)
        self.norm_out = norm(cin)
        self.conv_out = nn.Conv2d(cin, d["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _blocks(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        ch, mult = d["ch"], d["ch_mult"]
        cin = ch * mult[-1]
        res = d["resolution"] // 2 ** (len(mult) - 1)
        self.conv_in = nn.Conv2d(d["z_channels"], cin, 3, padding=1)
        self.mid = _mid(cin)
        levels = {}
        for i in reversed(range(len(mult))):
            level = _level()
            for _ in range(d["num_res_blocks"] + 1):
                level.block.append(ResnetBlock(cin, ch * mult[i]))
                cin = ch * mult[i]
                if res in d["attn_resolutions"]:
                    level.attn.append(AttnBlock(cin))
            if i != 0:
                level.upsample = Upsample(cin)
                res *= 2
            levels[i] = level
        self.up = nn.ModuleList(levels[i] for i in range(len(mult)))
        self.norm_out = norm(cin)
        self.conv_out = nn.Conv2d(cin, 3, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            h = _blocks(self.up[i], h)
            if hasattr(self.up[i], "upsample"):
                h = self.up[i].upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class Quantize(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def nearest(self, flat):
        """(M, C) → (M,) the nearest code, first on ties, in exact float32."""
        cb = self.embedding.weight
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cross = flat @ cb.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        d = (flat ** 2).sum(1, keepdim=True) - 2.0 * cross + (cb ** 2).sum(1)[None]
        return d.argmin(1)

    def forward(self, z):
        """(B, C, H, W) → the same, every vector its nearest code; the gradient passes straight through."""
        b, c, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, c)
        zq = self.embedding.weight[self.nearest(flat.detach())].reshape(b, h, w, c).permute(0, 3, 1, 2)
        return z + (zq - z).detach()


class VQGAN(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        self.dims = d
        self.encoder = Encoder(d)
        self.decoder = Decoder(d)
        self.quant_conv = nn.Conv2d(d["z_channels"], d["embed_dim"], 1)
        self.post_quant_conv = nn.Conv2d(d["embed_dim"], d["z_channels"], 1)
        self.quantize = Quantize(d["n_embed"], d["embed_dim"])

    def encode(self, x):
        return self.quantize(self.quant_conv(self.encoder(x)))

    def decode_from_continuous(self, z):
        return self.decoder(self.post_quant_conv(self.quantize(z)))
