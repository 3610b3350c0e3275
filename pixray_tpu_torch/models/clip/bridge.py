"""Flax CLIP variables → OpenAI CLIP state dict (the port's parameter names).

The inverse of ``pixray_tpu.models.clip.convert.convert_openai_clip`` (ViT
and ModifiedResNet towers) and of ``convert_slip_clip`` (timm towers, onto
the port's OpenAI names): transposes and renames only, no numerics change.
Input is the JAX package's variables (``{"params": ..., "batch_stats":
...}``, nested dicts of numpy-convertible arrays) or, for a tower without
BatchNorms, its ``params`` tree alone; output is a dict of float32 numpy
arrays keyed like OpenAI's checkpoint, ready for ``CLIP.load_state_dict``.
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


def _conv(out, key, p):
    out[key] = _np(p["kernel"]).transpose(3, 2, 0, 1).copy()  # (kh, kw, in, out) → (out, in, kh, kw)


def _bn(out, prefix, p, stats):
    _ln(out, prefix, p)
    out[f"{prefix}.running_mean"] = _np(stats["mean"])
    out[f"{prefix}.running_var"] = _np(stats["var"])


def _vit(out, v, config):
    p, width = config.vision_patch_size, config.vision_width
    kernel = _np(v["patch_embedding"]).reshape(p, p, 3, width)
    out["visual.conv1.weight"] = kernel.transpose(3, 2, 0, 1).copy()  # (width, 3, p, p)
    if config.vision_style == "timm":
        out["visual.conv1.bias"] = _np(v["patch_bias"])
    else:
        _ln(out, "visual.ln_pre", v["ln_pre"])
    out["visual.class_embedding"] = _np(v["class_embedding"])
    out["visual.positional_embedding"] = _np(v["positional_embedding"])
    _ln(out, "visual.ln_post", v["ln_post"])
    out["visual.proj"] = _np(v["proj"])
    _transformer(out, "visual.transformer", v["transformer"], config.vision_layers)


def _resnet(out, v, stats, config):
    for i in (1, 2, 3):
        _conv(out, f"visual.conv{i}.weight", v[f"conv{i}"])
        _bn(out, f"visual.bn{i}", v[f"bn{i}"], stats[f"bn{i}"])
    for stage, blocks in enumerate(config.vision_layers):
        for blk in range(blocks):
            name, pre = f"layer{stage + 1}_{blk}", f"visual.layer{stage + 1}.{blk}"
            b, s = v[name], stats[name]
            for i in (1, 2, 3):
                _conv(out, f"{pre}.conv{i}.weight", b[f"conv{i}"])
                _bn(out, f"{pre}.bn{i}", b[f"bn{i}"], s[f"bn{i}"])
            if "downsample_conv" in b:
                _conv(out, f"{pre}.downsample.0.weight", b["downsample_conv"])
                _bn(out, f"{pre}.downsample.1", b["downsample_bn"], s["downsample_bn"])
    pool = v["attnpool"]
    out["visual.attnpool.positional_embedding"] = _np(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(out, f"visual.attnpool.{proj}", pool[proj])


def state_dict_from_flax(variables, config) -> dict:
    """``variables`` = the flax variables of a CLIP (a ResNet tower needs
    their ``"batch_stats"``), or the ``"params"`` collection of a ViT's."""
    params = variables["params"] if "params" in variables else variables
    out: dict = {}
    if config.vision_kind == "vit":
        _vit(out, params["visual"], config)
    else:
        if "batch_stats" not in variables:
            raise ValueError(f"bridge: the ResNet tower {config.name} needs the variables' batch_stats")
        _resnet(out, params["visual"], variables["batch_stats"]["visual"], config)

    t = params["text"]
    out["token_embedding.weight"] = _np(t["token_embedding"])
    out["positional_embedding"] = _np(t["positional_embedding"])
    _ln(out, "ln_final", t["ln_final"])
    out["text_projection"] = _np(t["text_projection"])
    _transformer(out, "transformer", t["transformer"], config.text_layers)
    return out
