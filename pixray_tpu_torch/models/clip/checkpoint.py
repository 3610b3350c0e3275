"""Perceptor checkpoint files → the port's state dict (OpenAI CLIP names).

Three layouts, each mapped straight onto ``CLIP``'s parameter names:

- OpenAI CLIP: a TorchScript archive (``clip.load``'s ``.pt`` files, fp16
  weights) or a plain state dict.  Already the port's names; the archive's
  non-parameter entries (``input_resolution``, ``context_length``,
  ``vocab_size``, ``logit_scale``) are dropped.
- HuggingFace ``CLIPModel``: ``vision_model.*`` / ``text_model.*``, with
  separate q/k/v projections concatenated into ``in_proj``.
- SLIP (facebookresearch/SLIP): a timm ViT trunk (``visual.patch_embed``,
  ``visual.blocks.N``, ``visual.norm``, ``image_projection``) beside an
  OpenAI-style text tower; the DDP ``module.`` prefix is stripped.

Every tensor is taken to float32.  The perceptor loads the result with
``load_state_dict(strict=True)``, so a key the layout misses raises.
"""

from __future__ import annotations

import torch

_OPENAI_EXTRAS = ("input_resolution", "context_length", "vocab_size", "logit_scale")

# SLIP name → port name, by prefix; within a block, by infix
_SLIP_PREFIXES = (
    ("visual.patch_embed.proj.", "visual.conv1."),
    ("visual.cls_token", "visual.class_embedding"),
    ("visual.pos_embed", "visual.positional_embedding"),
    ("visual.norm.", "visual.ln_post."),
    ("image_projection", "visual.proj"),
    ("visual.blocks.", "visual.transformer.resblocks."),
)
_SLIP_BLOCK = (
    (".norm1.", ".ln_1."), (".norm2.", ".ln_2."), (".attn.qkv.weight", ".attn.in_proj_weight"),
    (".attn.qkv.bias", ".attn.in_proj_bias"), (".attn.proj.", ".attn.out_proj."),
    (".mlp.fc1.", ".mlp.c_fc."), (".mlp.fc2.", ".mlp.c_proj."),
)


def read_state_dict(path: str) -> dict:
    """A TorchScript archive's or a ``torch.save``d file's tensors (under
    its ``"state_dict"`` key, where it has one), in float32."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)  # SLIP files pickle their run's args
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}


def slip_name(key: str) -> str:
    """A SLIP checkpoint key (without ``module.``) under the port's name."""
    for old, new in _SLIP_PREFIXES:
        if key.startswith(old):
            key = new + key[len(old):]
            break
    if key.startswith("visual.transformer.resblocks."):
        for old, new in _SLIP_BLOCK:
            key = key.replace(old, new)
    return key


def _from_slip(sd: dict, wanted: set) -> dict:
    out = {}
    for k, v in sd.items():
        name = slip_name(k)
        if name in wanted:
            out[name] = v
    width = out["visual.conv1.weight"].shape[0]
    out["visual.class_embedding"] = out["visual.class_embedding"].reshape(width)
    out["visual.positional_embedding"] = out["visual.positional_embedding"].reshape(-1, width)
    return out


def _from_hf(sd: dict, config) -> dict:
    out = {}

    def ln(dst, src):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    def layers(dst, src, n):
        for i in range(n):
            d, s = f"{dst}.resblocks.{i}", f"{src}.layers.{i}"
            ln(f"{d}.ln_1", f"{s}.layer_norm1")
            ln(f"{d}.ln_2", f"{s}.layer_norm2")
            for part in ("weight", "bias"):
                out[f"{d}.attn.in_proj_{part}"] = torch.cat(
                    [sd[f"{s}.self_attn.{x}_proj.{part}"] for x in "qkv"], dim=0)
                out[f"{d}.attn.out_proj.{part}"] = sd[f"{s}.self_attn.out_proj.{part}"]
                out[f"{d}.mlp.c_fc.{part}"] = sd[f"{s}.mlp.fc1.{part}"]
                out[f"{d}.mlp.c_proj.{part}"] = sd[f"{s}.mlp.fc2.{part}"]

    emb = "vision_model.embeddings"
    out["visual.conv1.weight"] = sd[f"{emb}.patch_embedding.weight"]
    out["visual.class_embedding"] = sd[f"{emb}.class_embedding"]
    out["visual.positional_embedding"] = sd[f"{emb}.position_embedding.weight"]
    ln("visual.ln_pre", "vision_model.pre_layrnorm")
    ln("visual.ln_post", "vision_model.post_layernorm")
    out["visual.proj"] = sd["visual_projection.weight"].t()
    layers("visual.transformer", "vision_model.encoder", config.vision_layers)
    out["token_embedding.weight"] = sd["text_model.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd["text_model.embeddings.position_embedding.weight"]
    ln("ln_final", "text_model.final_layer_norm")
    out["text_projection"] = sd["text_projection.weight"].t()
    layers("transformer", "text_model.encoder", config.text_layers)
    return out


def port_state_dict(sd: dict, config, wanted: set) -> dict:
    """A checkpoint's tensors in any of the three layouts → the port's
    names.  ``wanted``: the model's own keys (a SLIP file's heads that the
    perceptor has no use for are left out)."""
    if any(k.startswith("module.") for k in sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if any(k.startswith("vision_model.") for k in sd):
        return _from_hf(sd, config)
    if any(k.startswith("visual.patch_embed") for k in sd):
        return _from_slip(sd, wanted)
    return {k: v for k, v in sd.items() if k not in _OPENAI_EXTRAS}
