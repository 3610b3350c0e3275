"""Flax CLIP params → OpenAI CLIP state dict (the port's parameter names).

The inverse of ``pixray_tpu.models.clip.convert.convert_openai_clip`` for ViT
towers: transposes and renames only, no numerics change.  Input is the
``params`` tree of the JAX package (nested dicts of numpy-convertible
arrays); output is a dict of float32 numpy arrays keyed like OpenAI's
checkpoint, ready for ``CLIP.load_state_dict``.
"""

from __future__ import annotations

import numpy as np


def _np(x):
    return np.array(x, dtype=np.float32)  # a writable copy


def _ln(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _dense(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["kernel"]).T
    out[f"{prefix}.bias"] = _np(p["bias"])


def _transformer(out, prefix, tree, layers):
    for i in range(layers):
        blk = tree[f"resblock_{i}"]
        pre = f"{prefix}.resblocks.{i}"
        _ln(out, f"{pre}.ln_1", blk["ln_1"])
        _ln(out, f"{pre}.ln_2", blk["ln_2"])
        out[f"{pre}.attn.in_proj_weight"] = _np(blk["attn"]["in_proj"]["kernel"]).T
        out[f"{pre}.attn.in_proj_bias"] = _np(blk["attn"]["in_proj"]["bias"])
        _dense(out, f"{pre}.attn.out_proj", blk["attn"]["out_proj"])
        _dense(out, f"{pre}.mlp.c_fc", blk["mlp_fc"])
        _dense(out, f"{pre}.mlp.c_proj", blk["mlp_proj"])


def state_dict_from_flax(params, config) -> dict:
    """``params`` = the flax tree's ``"params"`` collection of a ViT CLIP."""
    if config.vision_kind != "vit" or config.vision_style != "openai":
        raise NotImplementedError(f"bridge: only OpenAI ViT towers are ported ({config.name})")
    out: dict = {}
    v = params["visual"]
    p, width = config.vision_patch_size, config.vision_width
    kernel = _np(v["patch_embedding"]).reshape(p, p, 3, width)
    out["visual.conv1.weight"] = kernel.transpose(3, 2, 0, 1).copy()  # (width, 3, p, p)
    out["visual.class_embedding"] = _np(v["class_embedding"])
    out["visual.positional_embedding"] = _np(v["positional_embedding"])
    _ln(out, "visual.ln_pre", v["ln_pre"])
    _ln(out, "visual.ln_post", v["ln_post"])
    out["visual.proj"] = _np(v["proj"])
    _transformer(out, "visual.transformer", v["transformer"], config.vision_layers)

    t = params["text"]
    out["token_embedding.weight"] = _np(t["token_embedding"])
    out["positional_embedding"] = _np(t["positional_embedding"])
    _ln(out, "ln_final", t["ln_final"])
    out["text_projection"] = _np(t["text_projection"])
    _transformer(out, "transformer", t["transformer"], config.text_layers)
    return out
