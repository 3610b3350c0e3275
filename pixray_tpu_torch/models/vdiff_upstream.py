"""Upstream-shaped v-diffusion UNets: the layout spec, the executor and
checkpoint loading (port of ``pixray_tpu/models/vdiff_upstream.py``).

One spec per model (a copy of the JAX package's, held equal by the tests)
drives the module tree, whose parameters carry the upstream torch names
(``net.<i>.main.<j>...``: pooling, ReLU and upsampling take an index of
their ``nn.Sequential`` though they have no parameters), so a published
``.pth`` loads with ``load_state_dict(strict=True)`` once its keys and
shapes pass the check ``convert_vdiff_state_dict`` makes in the JAX
package (``check_state_dict``).  ``state_dict_from_vdiff_params`` is that
converter's inverse: it brings the JAX executor's parameters over.

Ops (each consumes one index of its containing Sequential):
  ("conv",    c_in, c_mid, c_out, is_last)   ResConvBlock
  ("modconv", c_in, c_mid, c_out, is_last)   ResModConvBlock (cc12m family)
  ("attn",    c, n_head)                     SelfAttention2d
  ("down",)                                  2x2 mean
  ("up",)                                    bilinear x2 (jax.image.resize's, half-pixel centres)
  ("skip", [subops])                         SkipBlock: cat([main(x), x], channels)

Precision (``to_compute_dtype``): the convolutions, the attention's
probabilities × values and the activations between them run in the
compute dtype (bf16 on the card under ``--precision bf16``), in
``channels_last``; the Fourier features, the mapping network and the
modulation, GroupNorm (statistics and normalization), attention scores
(the compute-dtype q and k scaled and multiplied in f32) and the softmax
in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vdiff import fourier_features

# ---------------------------------------------------------------------------
# spec (a copy of the JAX package's)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UpstreamSpec:
    name: str
    resolution: int
    cs: tuple  # channels per level, outermost first
    attn_levels: tuple  # level indices with self-attention
    conv_kind: str  # "conv" | "modconv"
    net: tuple = field(default=())  # nested op tree (built by build_spec)
    clip_embed_dim: int | None = None  # cc12m family conditioning
    mapping_width: int = 1024
    mapping_ff: int = 128  # mapping-network Fourier width
    input_ff: int = 16  # timestep planes concatenated to the input
    clip_model: str | None = None


def _level_ops(cs, attn_levels, kind, d, in_ch, out_ch, n_blocks, n_inner):
    """Ops for level ``d`` (inside level d-1's SkipBlock, or the whole net
    for d = 0): ``n_blocks`` conv blocks down and again up per outer level,
    ``n_inner`` at the innermost; an attention level has a SelfAttention2d
    after every conv block but the net's final one."""
    c = cs[d]
    att = d in attn_levels
    head = lambda ch: ("attn", ch, max(1, ch // 64))
    ops = []
    if d == len(cs) - 1:
        prev = in_ch
        for i in range(n_inner):
            o = out_ch if i == n_inner - 1 else c
            ops.append((kind, prev, c, o, False))
            prev = o
            if att:
                ops.append(head(o))
        return ops
    prev = in_ch
    for _ in range(n_blocks):
        ops.append((kind, prev, c, c, False))
        prev = c
        if att:
            ops.append(head(c))
    inner = [("down",)] + _level_ops(cs, attn_levels, kind, d + 1, c, c, n_blocks, n_inner) + [("up",)]
    ops.append(("skip", tuple(inner)))
    is_out = d == 0
    prev = c * 2
    for i in range(n_blocks):
        final = i == n_blocks - 1
        o = out_ch if final else c
        ops.append((kind, prev, c, o, is_out and final))
        prev = o
        if att and not (is_out and final):
            ops.append(head(o))
    return ops


def build_spec(name, resolution, cs, attn_levels, conv_kind, n_blocks=2, n_inner=4, **kw) -> UpstreamSpec:
    in_ch = 3 + kw.get("input_ff", 16)
    net = tuple(_level_ops(cs, attn_levels, conv_kind, 0, in_ch, 3, n_blocks, n_inner))
    return UpstreamSpec(name=name, resolution=resolution, cs=tuple(cs), attn_levels=tuple(attn_levels),
                        conv_kind=conv_kind, net=net, **kw)


_C = 128

# the published parameter counts (millions), which the specs reproduce to < 1%
PUBLISHED_PARAM_COUNTS_M = {
    "danbooru_128": 244, "imagenet_128": 244, "wikiart_128": 244,
    "wikiart_256": 244, "yfcc_1": 481, "yfcc_2": 968,
    "cc12m_1": 602, "cc12m_1_cfg": 602,
}

_CS_128 = (_C, 2 * _C, 2 * _C, 4 * _C, 4 * _C, 8 * _C)
UPSTREAM_SPECS = {
    "danbooru_128": build_spec("danbooru_128", 128, _CS_128, (3, 4, 5), "conv", 4, 6),
    "imagenet_128": build_spec("imagenet_128", 128, _CS_128, (3, 4, 5), "conv", 4, 6),
    "wikiart_128": build_spec("wikiart_128", 128, _CS_128, (3, 4, 5), "conv", 4, 6),
    "wikiart_256": build_spec("wikiart_256", 256, _CS_128, (3, 4, 5), "conv", 4, 6),
    "yfcc_1": build_spec("yfcc_1", 512, (_C // 2, _C, 2 * _C, 2 * _C, 4 * _C, 4 * _C, 8 * _C, 8 * _C),
                         (5, 6, 7), "conv", 4, 8),
    "yfcc_2": build_spec("yfcc_2", 512, (_C, 2 * _C, 4 * _C, 4 * _C, 8 * _C, 8 * _C, 16 * _C, 16 * _C),
                         (5, 6, 7), "conv", 2, 4),
    "cc12m_1": build_spec("cc12m_1", 256, (_C, 2 * _C, 2 * _C, 4 * _C, 4 * _C, 8 * _C, 8 * _C),
                          (4, 5, 6), "modconv", 4, 8, clip_embed_dim=512, clip_model="ViT-B/16"),
    "cc12m_1_cfg": build_spec("cc12m_1_cfg", 256, (_C, 2 * _C, 2 * _C, 4 * _C, 4 * _C, 8 * _C, 8 * _C),
                              (4, 5, 6), "modconv", 4, 8, clip_embed_dim=512, clip_model="ViT-B/16"),
    # tiny CI models exercising both block kinds end to end
    "tiny_up": build_spec("tiny_up", 32, (8, 16), (1,), "conv"),
    "tiny_up_mod": build_spec("tiny_up_mod", 32, (8, 16), (1,), "modconv", clip_embed_dim=12, mapping_width=16,
                              mapping_ff=8, clip_model="TinyTest"),
}


# ---------------------------------------------------------------------------
# state-dict shape signature
# ---------------------------------------------------------------------------


def _conv_block_shapes(kind, c_in, c_mid, c_out, is_last, path, feats_in, out):
    out[f"{path}.main.0.weight"] = (c_mid, c_in, 3, 3)
    out[f"{path}.main.0.bias"] = (c_mid,)
    if kind == "conv":
        # main: 0 Conv, 1 ReLU, 2 Conv, 3 ReLU/Identity
        out[f"{path}.main.2.weight"] = (c_out, c_mid, 3, 3)
        out[f"{path}.main.2.bias"] = (c_out,)
    else:
        # main: 0 Conv, 1 GroupNorm(affine=False), 2 Modulation2d, 3 ReLU,
        #       4 Conv, 5 GroupNorm, 6 Modulation2d, 7 ReLU (5-7 Identity when is_last)
        out[f"{path}.main.2.layer.weight"] = (c_mid * 2, feats_in)
        out[f"{path}.main.4.weight"] = (c_out, c_mid, 3, 3)
        out[f"{path}.main.4.bias"] = (c_out,)
        if not is_last:
            out[f"{path}.main.6.layer.weight"] = (c_out * 2, feats_in)
    if c_in != c_out:
        out[f"{path}.skip.weight"] = (c_out, c_in, 1, 1)


def _attn_shapes(c, path, out):
    out[f"{path}.norm.weight"] = (c,)
    out[f"{path}.norm.bias"] = (c,)
    out[f"{path}.qkv_proj.weight"] = (c * 3, c, 1, 1)
    out[f"{path}.qkv_proj.bias"] = (c * 3,)
    out[f"{path}.out_proj.weight"] = (c, c, 1, 1)
    out[f"{path}.out_proj.bias"] = (c,)


def _walk_shapes(ops, prefix, feats_in, out):
    for i, op in enumerate(ops):
        path = f"{prefix}.{i}"
        if op[0] in ("conv", "modconv"):
            _conv_block_shapes(op[0], *op[1:], path, feats_in, out)
        elif op[0] == "attn":
            _attn_shapes(op[1], path, out)
        elif op[0] == "skip":
            _walk_shapes(op[1], f"{path}.main", feats_in, out)


def expected_state_shapes(spec: UpstreamSpec) -> dict:
    """The torch-layout state dict's {key: shape} for ``spec``."""
    out: dict = {"timestep_embed.weight": (spec.input_ff // 2, 1)}
    if spec.conv_kind == "modconv":
        w, ed, ff = spec.mapping_width, spec.clip_embed_dim, spec.mapping_ff
        out["mapping_timestep_embed.weight"] = (ff // 2, 1)
        # mapping: ResLinearBlock(ed+ff, w, w), ResLinearBlock(w, w, w, is_last)
        out["mapping.0.main.0.weight"] = (w, ed + ff)
        out["mapping.0.main.0.bias"] = (w,)
        out["mapping.0.main.2.weight"] = (w, w)
        out["mapping.0.main.2.bias"] = (w,)
        out["mapping.0.skip.weight"] = (w, ed + ff)
        out["mapping.1.main.0.weight"] = (w, w)
        out["mapping.1.main.0.bias"] = (w,)
        out["mapping.1.main.2.weight"] = (w, w)
        out["mapping.1.main.2.bias"] = (w,)
    _walk_shapes(spec.net, "net", spec.mapping_width, out)
    return out


def check_state_dict(sd, spec: UpstreamSpec) -> None:
    """Raise KeyError / ValueError naming the key when ``sd``'s keys or
    shapes are not ``expected_state_shapes(spec)``."""
    expected = expected_state_shapes(spec)
    for k, shape in expected.items():
        if k not in sd:
            raise KeyError(f"{spec.name}: checkpoint missing parameter {k} {shape}")
        if tuple(sd[k].shape) != tuple(shape):
            raise ValueError(f"{spec.name}: {k} has shape {tuple(sd[k].shape)}, expected {shape}")
    extra = sorted(set(sd) - set(expected))
    if extra:
        raise ValueError(f"{spec.name}: checkpoint has {len(extra)} unmapped keys, e.g. {extra[:5]}")


def state_dict_from_vdiff_params(params, spec: UpstreamSpec) -> dict:
    """The JAX executor's flat parameters → the upstream state dict
    (float32 numpy): HWIO → OIHW and (in, out) → (out, in), the Fourier
    weights (stored (in, out/2)) back to (out/2, in); the inverse of
    ``convert_vdiff_state_dict``."""
    out = {}
    for k, shape in expected_state_shapes(spec).items():
        v = np.asarray(params[k], np.float32)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{spec.name}: {k} has shape {tuple(v.shape)}, expected {shape}")
        out[k] = np.ascontiguousarray(v)
    return out


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _group_norm1(x, weight=None, bias=None, eps=1e-5):
    """GroupNorm(1, c) in float32, as the JAX executor computes it: the
    population variance over (C, H, W) per sample, (x − mean)·rsqrt(var +
    eps), then the affine.  (``F.group_norm`` with one group reduces each
    sample in one thread block, which made it the cc12m step's costliest
    kernel on the H100.)"""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2, 3), correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight[:, None, None] + bias[:, None, None]
    return y


class FourierFeatures(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features // 2, in_features))

    def forward(self, t):
        return fourier_features(t, self.weight)


class ResLinearBlock(nn.Module):
    def __init__(self, f_in, f_mid, f_out, is_last=False):
        super().__init__()
        self.is_last = is_last
        self.main = nn.Sequential(nn.Linear(f_in, f_mid), nn.ReLU(), nn.Linear(f_mid, f_out),
                                  nn.Identity() if is_last else nn.ReLU())
        self.skip = nn.Linear(f_in, f_out, bias=False) if f_in != f_out else nn.Identity()

    def forward(self, x):
        return self.main(x) + self.skip(x)


class Modulation2d(nn.Module):
    """shifts + h · (scales + 1), (scales, shifts) = cond @ Wᵀ (no bias; scales first)."""

    def __init__(self, feats_in: int, c: int):
        super().__init__()
        self.layer = nn.Linear(feats_in, c * 2, bias=False)

    def forward(self, h, cond):
        scales, shifts = self.layer(cond).chunk(2, dim=-1)
        return shifts[:, :, None, None] + h * (scales[:, :, None, None] + 1.0)


class ResConvBlock(nn.Module):
    def __init__(self, c_in, c_mid, c_out, is_last):
        super().__init__()
        self.is_last = is_last
        self.main = nn.Sequential(nn.Conv2d(c_in, c_mid, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(c_mid, c_out, 3, padding=1), nn.Identity() if is_last else nn.ReLU())
        self.skip = nn.Conv2d(c_in, c_out, 1, bias=False) if c_in != c_out else nn.Identity()

    def forward(self, x, cond=None):
        h = self.main[2](F.relu(self.main[0](x)))
        if not self.is_last:
            h = F.relu(h)
        return h + self.skip(x)


class ResModConvBlock(nn.Module):
    def __init__(self, feats_in, c_in, c_mid, c_out, is_last):
        super().__init__()
        self.is_last = is_last
        self.main = nn.Sequential(
            nn.Conv2d(c_in, c_mid, 3, padding=1), nn.GroupNorm(1, c_mid, affine=False), Modulation2d(feats_in, c_mid),
            nn.ReLU(), nn.Conv2d(c_mid, c_out, 3, padding=1),
            *((nn.Identity(),) * 3 if is_last else
              (nn.GroupNorm(1, c_out, affine=False), Modulation2d(feats_in, c_out), nn.ReLU())))
        self.skip = nn.Conv2d(c_in, c_out, 1, bias=False) if c_in != c_out else nn.Identity()

    def forward(self, x, cond):
        h = self.main[0](x)
        h = F.relu(self.main[2](_group_norm1(h), cond)).to(x.dtype)
        h = self.main[4](h)
        if not self.is_last:
            h = F.relu(self.main[6](_group_norm1(h), cond)).to(x.dtype)
        return h + self.skip(x)


class SelfAttention2d(nn.Module):
    """GroupNorm(1, c) with affine and eps 1e-5; the channels split as all
    q-heads, then all k-heads, then all v-heads; d ** -0.25 on q and k."""

    def __init__(self, c: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.norm = nn.GroupNorm(1, c)
        self.qkv_proj = nn.Conv2d(c, c * 3, 1)
        self.out_proj = nn.Conv2d(c, c, 1)

    def forward(self, x, cond=None):
        b, c, h, w = x.shape
        d = c // self.n_head
        y = _group_norm1(x, self.norm.weight, self.norm.bias, self.norm.eps).to(x.dtype)
        q, k, v = self.qkv_proj(y).reshape(b, 3, self.n_head, d, h * w).unbind(1)
        scale = d**-0.25
        scores = torch.matmul((q.float() * scale).transpose(2, 3), k.float() * scale)  # (b, head, q, k)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(2, 3)).reshape(b, c, h, w)
        return x + self.out_proj(out.contiguous(memory_format=torch.channels_last))


class _Down(nn.Module):
    def forward(self, x, cond=None):
        return F.avg_pool2d(x, 2)


class _Up(nn.Module):
    def forward(self, x, cond=None):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class SkipBlock(nn.Module):
    def __init__(self, main):
        super().__init__()
        self.main = nn.Sequential(*main)

    def forward(self, x, cond=None):
        return torch.cat([_run(self.main, x, cond), x], dim=1)


def _run(seq, x, cond):
    for m in seq:
        x = m(x, cond)
    return x


def _build(ops, feats_in):
    mods = []
    for op in ops:
        kind = op[0]
        if kind == "conv":
            mods.append(ResConvBlock(*op[1:]))
        elif kind == "modconv":
            mods.append(ResModConvBlock(feats_in, *op[1:]))
        elif kind == "attn":
            mods.append(SelfAttention2d(op[1], op[2]))
        elif kind == "down":
            mods.append(_Down())
        elif kind == "up":
            mods.append(_Up())
        elif kind == "skip":
            mods.append(SkipBlock(_build(op[1], feats_in)))
        else:
            raise ValueError(f"unknown op {op}")
    return mods


class VDiffUpstream(nn.Module):
    """x (B, 3, H, W), t (B,) or (1,) → v (B, 3, H, W) float32; the cc12m
    family takes ``clip_embed`` (normalized, times sqrt(dim); zeros when None)."""

    def __init__(self, spec: UpstreamSpec):
        super().__init__()
        self.spec = spec
        self.timestep_embed = FourierFeatures(1, spec.input_ff)
        if spec.conv_kind == "modconv":
            w = spec.mapping_width
            self.mapping_timestep_embed = FourierFeatures(1, spec.mapping_ff)
            self.mapping = nn.Sequential(ResLinearBlock(spec.clip_embed_dim + spec.mapping_ff, w, w),
                                         ResLinearBlock(w, w, w, is_last=True))
        self.net = nn.Sequential(*_build(spec.net, spec.mapping_width))

    @property
    def compute_dtype(self):
        return self.net[0].main[0].weight.dtype

    def to_compute_dtype(self, dtype):
        """Convolutions in ``dtype`` and ``channels_last`` (cuDNN's NHWC
        kernels, no layout transposes around them); Fourier features,
        mapping, modulation and norms stay f32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype=dtype, memory_format=torch.channels_last)
        return self

    def forward(self, x, t, clip_embed=None):
        spec = self.spec
        b, _, h, w = x.shape
        t = t.float().reshape(-1, 1).expand(b, 1)
        cond = None
        if spec.conv_kind == "modconv":
            if clip_embed is None:
                clip_embed = torch.zeros((b, spec.clip_embed_dim), device=x.device)
            ce = clip_embed.float().reshape(-1, spec.clip_embed_dim).expand(b, spec.clip_embed_dim)
            norm = torch.linalg.vector_norm(ce, dim=-1, keepdim=True)
            ce = ce / torch.clamp(norm, min=1e-12) * math.sqrt(spec.clip_embed_dim)
            cond = self.mapping(torch.cat([ce, self.mapping_timestep_embed(t)], dim=-1))
        te = self.timestep_embed(t)
        planes = te[:, :, None, None].expand(b, te.shape[-1], h, w)
        hidden = torch.cat([x.float(), planes], dim=1).to(self.compute_dtype)
        return _run(self.net, hidden.contiguous(memory_format=torch.channels_last), cond).float()


@torch.no_grad()
def init_random_(model: nn.Module, gen) -> nn.Module:
    """Seeded random weights, drawn where the model lives (``gen`` on its
    device), in the JAX package's ``init_params`` distributions: Fourier
    weights normal(0, 1); conv and linear weights uniform ±1/sqrt(fan_in);
    biases 0; norm scales 1."""
    for name, p in model.named_parameters():
        if name.endswith("timestep_embed.weight") or name == "timestep_embed":
            p.normal_(generator=gen)
        elif p.dim() >= 2:
            fan_in = p[0].numel()
            p.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in), generator=gen)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return model
