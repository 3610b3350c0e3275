"""OpenAI CLIP family configurations (same table as ``pixray_tpu.models.clip.configs``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    # vision
    image_resolution: int
    vision_kind: str  # "vit" | "resnet"
    vision_width: int
    vision_layers: object  # int (vit) | tuple (resnet stage depths)
    vision_patch_size: int | None
    vision_heads: int
    # text
    context_length: int
    vocab_size: int
    text_width: int
    text_heads: int
    text_layers: int
    # "openai" (ln_pre, no patch bias, QuickGELU) or "timm" (patch bias, no
    # ln_pre, GELU vision MLPs) — the SLIP family uses timm ViT trunks
    vision_style: str = "openai"


def _vit(name, embed_dim, res, width, layers, patch, style="openai"):
    return CLIPConfig(
        name=name,
        embed_dim=embed_dim,
        image_resolution=res,
        vision_kind="vit",
        vision_width=width,
        vision_layers=layers,
        vision_patch_size=patch,
        vision_heads=width // 64,
        context_length=77,
        vocab_size=49408,
        text_width=512,
        text_heads=8,
        text_layers=12,
        vision_style=style,
    )


def _rn(name, embed_dim, res, width, layers, text_width, text_heads):
    return CLIPConfig(
        name=name,
        embed_dim=embed_dim,
        image_resolution=res,
        vision_kind="resnet",
        vision_width=width,
        vision_layers=layers,
        vision_patch_size=None,
        vision_heads=width // 2,  # attnpool heads = vision_width * 32 // 64
        context_length=77,
        vocab_size=49408,
        text_width=text_width,
        text_heads=text_heads,
        text_layers=12,
    )


CLIP_CONFIGS = {
    # tiny perceptor for CI/e2e tests (random weights; CPU-fast)
    "TinyTest": CLIPConfig(
        name="TinyTest", embed_dim=32, image_resolution=32, vision_kind="vit",
        vision_width=64, vision_layers=2, vision_patch_size=8, vision_heads=2,
        context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2,
    ),
    # second tiny perceptor at a different resolution for ensemble tests
    "TinyTest48": CLIPConfig(
        name="TinyTest48", embed_dim=32, image_resolution=48, vision_kind="vit",
        vision_width=64, vision_layers=2, vision_patch_size=16, vision_heads=2,
        context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2,
    ),
    # third tiny perceptor with a different embed dim (ensemble d_max padding)
    "TinyTestDim48": CLIPConfig(
        name="TinyTestDim48", embed_dim=48, image_resolution=32, vision_kind="vit",
        vision_width=64, vision_layers=2, vision_patch_size=8, vision_heads=2,
        context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2,
    ),
    "ViT-B/32": _vit("ViT-B/32", 512, 224, 768, 12, 32),
    "ViT-B/16": _vit("ViT-B/16", 512, 224, 768, 12, 16),
    "ViT-L/14": _vit("ViT-L/14", 768, 224, 1024, 24, 14),
    "RN50": _rn("RN50", 1024, 224, 64, (3, 4, 6, 3), 512, 8),
    "RN101": _rn("RN101", 512, 224, 64, (3, 4, 23, 3), 512, 8),
    "RN50x4": _rn("RN50x4", 640, 288, 80, (4, 6, 10, 6), 640, 10),
    "RN50x16": _rn("RN50x16", 768, 384, 96, (6, 8, 18, 8), 768, 12),
}

# SLIP-family perceptors reuse the ViT trunk with ImageNet preprocessing
# stats; resolution is always 224.
SLIP_CONFIGS = {
    "SLIP_VITS16": _vit("SLIP_VITS16", 512, 224, 384, 12, 16, "timm"),
    "SLIP_VITB16": _vit("SLIP_VITB16", 512, 224, 768, 12, 16, "timm"),
    "SLIP_VITL16": _vit("SLIP_VITL16", 512, 224, 1024, 24, 16, "timm"),
    "SLIP_CC3M": _vit("SLIP_CC3M", 512, 224, 768, 12, 16, "timm"),
    "SLIP_CC12M": _vit("SLIP_CC12M", 512, 224, 768, 12, 16, "timm"),
    "SIMCLR_VITS16": _vit("SIMCLR_VITS16", 512, 224, 384, 12, 16, "timm"),
    "CLIP_VITS16": _vit("CLIP_VITS16", 512, 224, 384, 12, 16, "timm"),
    "CLIP_VITB16": _vit("CLIP_VITB16", 512, 224, 768, 12, 16, "timm"),
    "CLIP_VITL16": _vit("CLIP_VITL16", 512, 224, 1024, 24, 16, "timm"),
}

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
