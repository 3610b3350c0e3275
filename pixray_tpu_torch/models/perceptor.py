"""Perceptor: a frozen CLIP or SLIP tower with the JAX package's scoring API.

Port of ``pixray_tpu/models/perceptor.py`` for every tower of
``CLIP_CONFIGS`` (OpenAI ViTs and ModifiedResNets) and ``SLIP_CONFIGS``
(timm ViT trunks, ImageNet statistics): ``image_fn`` (batch range-stretch +
standardization, folded into a ViT's patch embedding or applied before a
ResNet's stem, then the tower, then L2 normalization), ``encode_text`` and
``encode_text_with_stops``.  Weights come from a state dict (see
``clip/bridge.py``), else from a checkpoint file found by the JAX
package's names in ``$PIXRAY_TPU_MODELS``, ``models/`` or
``~/.cache/pixray_tpu`` (OpenAI, HuggingFace or SLIP layout, see
``clip/checkpoint.py``; nothing is downloaded), else from a seeded
``torch.Generator`` with the flax initializers' distributions and a loud
warning.

The precision rungs (``config/precision.py``, read when the perceptor is
built unless given): a bf16 ViT tower under ``PIXRAY_TPU_CLIP_PREC`` int8
or int8b runs its dense kernels and patch embedding on ``ops/quant.py``,
from s8 weights quantized once here from the float32 weights, before the
cast to bf16 (:func:`build_quant_collection`; ``PIXRAY_TPU_CLIP_PREQ=0``
quantizes the bf16 weights per call instead); every LayerNorm of a bf16
tower takes ``PIXRAY_TPU_CLIP_LN32``.
"""

from __future__ import annotations

import hashlib
import os

import torch

from pixray_tpu_torch.config.precision import Rungs, read_rungs
from pixray_tpu_torch.ops.grad import l2_normalize
from pixray_tpu_torch.ops.quant import prequantize_kernel
from pixray_tpu_torch.utils.files import find_model_file

from .clip.checkpoint import port_state_dict, read_state_dict
from .clip.configs import CLIP_CONFIGS, CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD, SLIP_CONFIGS
from .clip.model import CLIP, FrozenBatchNorm2d, LayerNorm, init_random_
from .clip.tokenizer import get_tokenizer, tokenize

# checkpoint file names, as the JAX package looks for them
_CKPT_ALIASES = {
    "TinyTest": ["tinytest.pt"],
    "ViT-B/32": ["ViT-B-32.pt", "vit_b_32.pt"],
    "ViT-B/16": ["ViT-B-16.pt", "vit_b_16.pt"],
    "ViT-L/14": ["ViT-L-14.pt"],
    "RN50": ["RN50.pt"],
    "RN101": ["RN101.pt"],
    "RN50x4": ["RN50x4.pt"],
    "RN50x16": ["RN50x16.pt"],
    "SLIP_VITS16": ["slip_small_100ep.pt"],
    "SLIP_VITB16": ["slip_base_100ep.pt"],
    "SLIP_VITL16": ["slip_large_100ep.pt"],
    "SIMCLR_VITS16": ["simclr_small_25ep.pt"],
    "CLIP_VITS16": ["clip_small_25ep.pt"],
    "CLIP_VITB16": ["clip_base_25ep.pt"],
    "CLIP_VITL16": ["clip_large_25ep.pt"],
    "SLIP_CC3M": ["slip_base_cc3m_40ep.pt"],
    "SLIP_CC12M": ["slip_base_cc12m_35ep.pt"],
}


def _find_checkpoint(name: str):
    return find_model_file(_CKPT_ALIASES.get(name, []))


def _require_checkpoint_tokenizer(name: str):
    """Real weights fed byte-level fallback ids give meaningless text
    embeddings: refuse them unless ``PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER=1``
    (image prompts only)."""
    if get_tokenizer().degraded and os.environ.get("PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER") != "1":
        raise RuntimeError(
            f"Perceptor {name!r} loaded REAL checkpoint weights but the CLIP BPE vocab "
            "(bpe_simple_vocab_16e6.txt.gz) is missing — text embeddings would be meaningless. Place the "
            "vocab under models/ or set $PIXRAY_TPU_BPE; to proceed anyway (image prompts only) set "
            "PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER=1.")


def _cast_towers_(model, dtype):
    """Every floating tensor to ``dtype`` but the BatchNorms' buffers and the
    LayerNorms' affines, which the towers apply in float32 (the JAX
    ``_cast_storage`` keeps every ``ln_*``, ``bn*``, ``norm*`` and
    ``downsample_bn`` leaf in float32)."""
    keep = {id(t) for m in model.modules() if isinstance(m, FrozenBatchNorm2d) for t in m.buffers()}
    keep |= {id(t) for m in model.modules() if isinstance(m, torch.nn.LayerNorm) for t in m.parameters()}
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point() and id(t) not in keep:
            t.data = t.data.to(dtype)


# the dense kernels of a ViT block that run the int8 rung (the JAX QuantDense names
# in_proj, out_proj, mlp_fc, mlp_proj)
QUANT_DENSE = ("attn.in_proj_weight", "attn.out_proj.weight", "mlp.c_fc.weight", "mlp.c_proj.weight")
PATCH_NHWC = "visual.conv1.weight:nhwc"  # the patch kernel in the JAX NHWC row order (py, px, c)


def build_quant_collection(model) -> dict:
    """The JAX ``build_quant_collection`` for a ViT ``model``'s vision tower,
    keyed by parameter name: every block's four dense kernels as (D, F)
    kernels (the weight transposed), and the patch kernel in both row orders
    (``"visual.conv1.weight"``: channel-major rows (c, py, px), which the
    tower reads; ``PATCH_NHWC``), each :func:`prequantize_kernel` of the
    model's weights as they are (float32 before the cast)."""
    visual = model.visual
    out = {}
    for i in range(len(visual.transformer.resblocks)):
        for name in QUANT_DENSE:
            key = f"visual.transformer.resblocks.{i}.{name}"
            out[key] = prequantize_kernel(model.get_parameter(key).detach().t())
    w = visual.conv1.weight.detach()  # (width, 3, p, p)
    out["visual.conv1.weight"] = prequantize_kernel(w.reshape(w.shape[0], -1).t())
    out[PATCH_NHWC] = prequantize_kernel(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).t())
    return out


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
    """A frozen scoring model on ``device`` (the card unless the caller
    asks for the CPU, as the Engine's).  ``dtype`` is the tower's compute dtype;
    ``rungs`` the precision rungs (None: read from the environment now).
    ``quant`` is the vision tower's int8 rung or None, ``quant_weights``
    its pre-quantized weights (:func:`build_quant_collection`) or None."""

    def __init__(self, name: str, device="cuda", dtype=torch.float32, state_dict=None, rungs: Rungs | None = None):
        if name in CLIP_CONFIGS:
            self.config, mean, std = CLIP_CONFIGS[name], CLIP_MEAN, CLIP_STD
        elif name in SLIP_CONFIGS:
            self.config, mean, std = SLIP_CONFIGS[name], IMAGENET_MEAN, IMAGENET_STD
        else:
            raise ValueError(f"Unknown perceptor: {name} (have {sorted(CLIP_CONFIGS) + sorted(SLIP_CONFIGS)})")
        self.name = name
        self.device = torch.device(device)
        self.dtype = dtype
        self.input_resolution = self.config.image_resolution
        self.output_dim = self.config.embed_dim
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        model = CLIP(self.config)
        ckpt = _find_checkpoint(name) if state_dict is None else None
        if ckpt is not None:
            state_dict = port_state_dict(read_state_dict(ckpt), self.config, set(model.state_dict()))
        if state_dict is None:
            print(
                f"WARNING: no checkpoint found for perceptor {name} — initializing random weights "
                "from a seed derived from its name (set $PIXRAY_TPU_MODELS or place weights under models/)."
            )
            stable = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
            init_random_(model, torch.Generator().manual_seed(stable % (2**31)))
        else:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        if ckpt is not None:
            n_params = sum(p.numel() for p in model.parameters())
            print(f"Loaded perceptor {name} from {ckpt}: {self.input_resolution}px, {n_params / 1e6:.2f}M params")
            _require_checkpoint_tokenizer(name)
        model = model.to(device=self.device).eval().requires_grad_(False)
        rungs = read_rungs() if rungs is None else rungs
        self.rungs = rungs
        self.quant = rungs.clip_quant(dtype == torch.bfloat16) if self.config.vision_kind == "vit" else None
        self.quant_weights = build_quant_collection(model) if self.quant and rungs.clip_preq else None
        _cast_towers_(model, dtype)
        if self.config.vision_kind == "vit":
            model.visual.set_quant(self.quant, self.quant_weights)
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.ln32 = rungs.clip_ln32
        if self.config.vision_kind == "resnet":
            model.visual.to(memory_format=torch.channels_last)
        self.model = model

    def preprocess_affine(self, imgs):
        """Per-channel (scale, shift) with ``imgs*scale + shift`` = the range
        stretch followed by the CLIP standardization."""
        a, b = adjust_range_affine(imgs)
        return a / self.std, (b - self.mean) / self.std

    def image_fn(self, imgs, affine=None):
        """(N, 3, S, S) cutouts in [0, 1] → (N, output_dim) L2-normalized
        embeddings; ``affine``: the :meth:`preprocess_affine` to apply (a
        mesh rank's chunk takes the whole bank's), by default ``imgs``'s own."""
        r = self.input_resolution
        if imgs.shape[2] != r or imgs.shape[3] != r:
            raise ValueError(f"cutouts must be {r}x{r} for {self.name}; got {tuple(imgs.shape)}")
        embeds = self.model.encode_image(imgs, self.preprocess_affine(imgs) if affine is None else affine)
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
