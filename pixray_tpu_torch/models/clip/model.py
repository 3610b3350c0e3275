"""CLIP image towers (ViT, timm-style ViT, ModifiedResNet) and the causal
text tower as ``nn.Module``s.

Port of ``VisionTransformer``, ``ModifiedResNet`` and ``TextTransformer`` in
``pixray_tpu/models/clip/model.py``.  Parameter names are OpenAI CLIP's
state-dict keys (``visual.conv1.weight``, ``transformer.resblocks.0.attn.in_proj_weight``,
``visual.layer1.0.bn1.running_mean``, ...), so ``bridge.py`` maps the JAX
package's flax variables onto them and an OpenAI state dict loads without a
converter.  A SLIP (timm) tower uses the same names, plus the patch conv's
bias ``visual.conv1.bias`` and no ``ln_pre`` (see ``perceptor.py`` for the
renaming of a SLIP file).

Numerics follow the JAX tower's rungs.  By default every matmul and
convolution runs in the module's parameter dtype (bf16 on the card under
``--precision bf16``, float32 in most CPU tests).  Attention in a bf16
tower is ``ops/attention.py``'s fused kernel (on the card; its plain
version on the CPU): float32 scores and softmax, the probabilities rounded
to bf16 only as PV's operand; the float32 rung keeps plain matmul +
softmax.  A ViT vision tower in bf16 can run
its four dense kernels per block and its patch embedding on the int8 rungs
of ``ops/quant.py`` (:meth:`VisionTransformer.set_quant`, the JAX
``QuantDense``): ``int8`` (int8 forward, bf16 dx) or ``int8b`` (int8 dx
too), from weights pre-quantized at load or quantized per call; the
score and probability matmuls stay in bf16.  :class:`LayerNorm` takes the
JAX ``PIXRAY_TPU_CLIP_LN32`` rung per module (``ln32``).  The
ViT patch embedding is one matmul on channel-major patches (the conv1
weight's own (c, py, px) row order), with the perceptor's preprocessing
affine folded into the kernel rows as the JAX tower does.  The ResNet
tower materialises the affine in float32 instead, and runs its frozen
BatchNorms, ReLUs and residual sums in float32 on the convolutions'
outputs, in the ``channels_last`` memory format.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from pixray_tpu_torch.ops.attention import attention
from pixray_tpu_torch.ops.quant import int8_matmul, int8_matmul_pre

from .configs import CLIPConfig


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) with the JAX tower's two rungs for a bf16
    input; the affine stays float32 in a bf16 tower, as the JAX package
    stores it.  ``ln32`` (``PIXRAY_TPU_CLIP_LN32=1``): statistics and the
    affine in float32, one rounding at the end: ``F.layer_norm`` of the
    input cast to float32 (on the card it takes no bf16 input with float32
    affines).  Otherwise the JAX
    ``LayerNorm`` as written for a bf16 input: the mean and variance as
    ``jnp.mean``/``jnp.var`` give them (float32 sums, rounded to bf16),
    ``(x - mean) * rsqrt(var + eps)`` in bf16, the affine in float32 and
    the result rounded to bf16.  An input of the affine's dtype takes
    ``F.layer_norm``."""

    ln32 = True

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        if self.ln32:
            return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        return (y.float() * self.weight.float() + self.bias.float()).to(x.dtype)


def dense(x, weight, bias, quant=None, pre=None):
    """``F.linear(x, weight, bias)``, or under ``quant`` ("int8" / "int8b")
    the JAX ``QuantDense``: the int8 product (from ``pre``, the weight
    pre-quantized at load, else quantized per call) in float32, cast to the
    weight's dtype, then the bias added in that dtype."""
    if quant is None:
        return F.linear(x, weight, bias)
    bwd = "int8" if quant == "int8b" else "bf16"
    y = int8_matmul_pre(x, pre, bwd) if pre is not None else int8_matmul(x, weight.t(), bwd)
    return y.to(weight.dtype) + bias.to(weight.dtype)


class MultiHeadAttention(nn.Module):
    """Packed-qkv attention with ``nn.MultiheadAttention``'s parameter names.
    ``quant``/``pre``: the rung of its two dense kernels (see :func:`dense`;
    ``pre`` maps their parameter names to pre-quantized weights)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)
        self.quant, self.pre = None, {}

    def forward(self, x, causal: bool = False):
        b, t, d = x.shape
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.quant, self.pre.get("in_proj_weight"))
        if x.dtype == torch.bfloat16:
            out = attention(qkv, self.heads, causal)
        else:
            hd = d // self.heads
            q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
            scores = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
            if causal:
                mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
                scores = scores.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        return dense(out, self.out_proj.weight, self.out_proj.bias, self.quant, self.pre.get("out_proj.weight"))


class _MLP(nn.Module):
    """``act``: QuickGELU (OpenAI towers, every text tower) or exact erf GELU
    (the timm vision trunks of the SLIP family).  ``quant``/``pre`` as in
    :class:`MultiHeadAttention`."""

    def __init__(self, width: int, act: str = "quick_gelu"):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)
        self.act = quick_gelu if act == "quick_gelu" else F.gelu
        self.quant, self.pre = None, {}

    def forward(self, x):
        h = self.act(dense(x, self.c_fc.weight, self.c_fc.bias, self.quant, self.pre.get("c_fc.weight")))
        return dense(h, self.c_proj.weight, self.c_proj.bias, self.quant, self.pre.get("c_proj.weight"))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str = "quick_gelu"):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = _MLP(width, act)

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, act: str = "quick_gelu"):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, act) for _ in range(layers))

    def forward(self, x, causal: bool = False):
        for block in self.resblocks:
            x = block(x, causal)
        return x


class _PatchConv(nn.Module):
    """Holds OpenAI's ``conv1.weight`` (width, 3, p, p), and for a timm
    trunk the patch conv's ``bias``; applied as a matmul."""

    def __init__(self, width: int, patch: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(width)) if bias else None


def patchify_cm(x, p: int):
    """(B, 3, gh*p, gw*p) → (B, gh*gw, 3*p*p) patches in (c, py, px) order."""
    b, c, hgt, wdt = x.shape
    gh, gw = hgt // p, wdt // p
    x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * p * p)


class VisionTransformer(nn.Module):
    """An OpenAI ViT or, with ``vision_style == "timm"``, a timm ViT trunk:
    a biased patch conv, no ``ln_pre``, exact GELU in the MLPs (LayerNorm
    eps 1e-5 in both, as the JAX tower has it)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        width, p = cfg.vision_width, cfg.vision_patch_size
        self.patch = p
        self.timm = cfg.vision_style == "timm"
        self.conv1 = _PatchConv(width, p, bias=self.timm)
        self.class_embedding = nn.Parameter(torch.empty(width))
        n_tok = (cfg.image_resolution // p) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width))
        self.ln_pre = None if self.timm else LayerNorm(width)
        self.transformer = Transformer(width, cfg.vision_layers, cfg.vision_heads,
                                       "gelu" if self.timm else "quick_gelu")
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))
        self.quant, self.patch_pre = None, None

    def set_quant(self, quant=None, pre=None):
        """The int8 rung of the dense kernels and the patch embedding:
        ``quant`` None, "int8" or "int8b"; ``pre``: None (weights quantized
        per call) or :func:`~pixray_tpu_torch.models.perceptor.build_quant_collection`'s
        dict, keyed by parameter name."""
        pre = (pre or {}) if quant else {}
        self.quant, self.patch_pre = quant, pre.get("visual.conv1.weight")
        for i, blk in enumerate(self.transformer.resblocks):
            for mod, prefix in ((blk.attn, f"visual.transformer.resblocks.{i}.attn."),
                                (blk.mlp, f"visual.transformer.resblocks.{i}.mlp.")):
                mod.quant = quant
                mod.pre = {k[len(prefix):]: v for k, v in pre.items() if k.startswith(prefix)}

    def forward(self, images, in_affine=None):
        """images: (B, 3, H, W).  ``in_affine`` = per-channel (scale, shift)
        with preprocessed = images*scale + shift, folded into the patch
        embedding (kernel rows scaled, shift as a constant token bias)."""
        p = self.patch
        dtype = self.proj.dtype
        x = patchify_cm(images.to(dtype), p)
        kernel = self.conv1.weight.reshape(self.conv1.weight.shape[0], -1)  # (width, 3pp)
        aff_bias = scale_rows = None
        if in_affine is not None:
            scale, shift = in_affine
            scale_rows = scale.float().repeat_interleave(p * p)
            aff_bias = torch.einsum(
                "wc,c->w", self.conv1.weight.float().sum(dim=(2, 3)), shift.float())
        if self.patch_pre is not None:
            # pre-quantized rows: the affine's scale moves to the activations
            if scale_rows is not None:
                x = x.float() * scale_rows
            x = int8_matmul_pre(x, self.patch_pre, "int8" if self.quant == "int8b" else "bf16")
        else:
            if scale_rows is not None:
                kernel = (kernel.float() * scale_rows[None, :]).to(dtype)
            if self.quant is not None:
                x = int8_matmul(x, kernel.t(), "int8" if self.quant == "int8b" else "bf16")
            else:
                x = torch.matmul(x, kernel.t()).float()
        if aff_bias is not None:
            x = x + aff_bias
        x = x.to(dtype)
        if self.conv1.bias is not None:  # the timm patch conv's bias, after the fold's
            x = x + self.conv1.bias.to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return torch.matmul(x, self.proj).float()


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d at its running statistics, every tensor a buffer
    (``weight``, ``bias``, ``running_mean``, ``running_var``: OpenAI's
    names; a file's ``num_batches_tracked`` is accepted and dropped).
    Applied in float32 to the convolution's output, eps 1e-5, as the JAX
    tower's ``nn.BatchNorm(dtype=float32)``; the perceptor keeps these
    buffers in float32 whatever the compute dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _conv(conv: nn.Conv2d, x):
    """The convolution in its weight's dtype (the input cast to it)."""
    return conv(x.to(conv.weight.dtype))


class Bottleneck(nn.Module):
    """ModifiedResNet bottleneck: 1x1, 3x3 and 1x1 convs at stride 1, an
    average pool after ``conv2`` where the stride is 2, and a downsample
    branch (average pool, 1x1 conv, BN) where the stride or the width
    changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.stride = stride
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False)), ("1", FrozenBatchNorm2d(planes * 4))]))

    def forward(self, x):
        out = F.relu(self.bn1(_conv(self.conv1, x)))
        out = F.relu(self.bn2(_conv(self.conv2, out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(_conv(self.conv3, out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample[1](_conv(self.downsample[0], identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The mean token prepended to the (h, w) row-major tokens, the
    positional table added in float32, one query (the mean's) over all
    tokens, float32 scores and softmax, then ``c_proj``."""

    def __init__(self, spatial: int, width: int, heads: int, out_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spatial * spatial + 1, width))
        self.k_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, out_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, HW, C), float32
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        dtype = self.q_proj.weight.dtype
        x = (x + self.positional_embedding.float()).to(dtype)
        hd = c // self.heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, -1, self.heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, -1, self.heads, hd).transpose(1, 2)
        q = q / float(torch.tensor(math.sqrt(hd)).to(dtype))  # sqrt(hd) rounded to the compute dtype, as JAX
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """The stem (three 3x3 convs, the first with stride 2, then a 2x2
    average pool), four stages of bottlenecks (stride 2 at the first block
    of stages 2-4) and the attention pool, with ``width * 32 // 64`` heads."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        width = cfg.vision_width
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes = width
        for stage, blocks in enumerate(cfg.vision_layers):
            planes = width * 2 ** stage
            layer = []
            for blk in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if (blk == 0 and stage > 0) else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, width * 32, width * 32 // 64, cfg.embed_dim)

    def forward(self, images):
        """images: (B, 3, H, W) preprocessed, float32."""
        x = images.contiguous(memory_format=torch.channels_last)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(bn(_conv(conv, x)))
        x = F.avg_pool2d(x, 2)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return self.attnpool(x).float()


class CLIP(nn.Module):
    """An image tower + the text tower with OpenAI's state-dict layout."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        self.visual = VisionTransformer(cfg) if cfg.vision_kind == "vit" else ModifiedResNet(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads)
        self.ln_final = LayerNorm(cfg.text_width)
        self.text_projection = nn.Parameter(torch.empty(cfg.text_width, cfg.embed_dim))

    def encode_image(self, images, in_affine=None):
        """images: (B, 3, H, W).  A ViT folds ``in_affine`` into its patch
        embedding; a ResNet starts with a strided conv, so the affine is
        applied to the images in float32 first."""
        if self.config.vision_kind == "vit":
            return self.visual(images, in_affine)
        if in_affine is not None:
            scale, shift = (a.float()[:, None, None] for a in in_affine)
            images = images.float() * scale + shift
        return self.visual(images)

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
    lecun_normal kernels and convolutions (fan-in, k*k*c_in for a conv),
    normal(0.02) embeddings and projections, normal(0.01) positional tables,
    unit/zero LayerNorms, zero biases; the BatchNorms keep their
    construction values (scale 1, bias 0, running mean 0, variance 1)."""
    def lecun(p, fan_in):
        p.copy_(_trunc_normal(p.shape, (1.0 / fan_in) ** 0.5, gen))

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    cfg = model.config
    v = model.visual
    towers = [model.transformer]
    if cfg.vision_kind == "vit":
        lecun(v.conv1.weight, 3 * cfg.vision_patch_size ** 2)
        if v.conv1.bias is not None:
            v.conv1.bias.zero_()
        normal(v.class_embedding, 0.02)
        normal(v.positional_embedding, 0.01)
        normal(v.proj, 0.02)
        towers.insert(0, v.transformer)
    else:
        for m in v.modules():
            if isinstance(m, nn.Conv2d):
                lecun(m.weight, m.weight[0].numel())
        pool = v.attnpool
        normal(pool.positional_embedding, 0.01)
        for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
            lecun(lin.weight, lin.in_features)
            lin.bias.zero_()
    normal(model.token_embedding.weight, 0.02)
    normal(model.positional_embedding, 0.01)
    normal(model.text_projection, 0.02)
    for tower in towers:
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
