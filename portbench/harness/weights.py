"""Random weights from the seed, made on the device in a few large calls.

The scales are those of the program's own seeded initialisation (flax's
initialisers): lecun-normal kernels and convolutions (standard deviation
1/sqrt(fan-in)), normal(0.02) embeddings and projections, normal(0.01)
positional tables, unit scales and zero shifts in every norm, zero biases;
but the VQGAN codebook is unit normal, not the program's uniform on
[0, 2 / n_embed).  That box is 1.2e-4 wide per dimension at 16384 codes:
every Adam step at the drawer's rate of 0.2 throws the latent into one of
its corners by its gradient's signs alone, so that the step's result no
longer depends on the towers, the bank or the batch.  One normal draw in
float32 covers every random tensor of a model, from one device generator
seeded from ``seed`` and the model's name, so the same seed
gives the same weights on the same device.  Names and shapes come from the
plain reference's modules, which carry the checkpoints' state-dict names.
"""

from __future__ import annotations

import hashlib

import torch

from portbench.reference.clip import CLIP
from portbench.reference.vqgan import VQGAN


def _clip_scale(name: str, shape, d: dict):
    """(kind, scale) of one CLIP tensor: ("normal", std), ("ones",) or ("zeros",)."""
    if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight", "ln_final.weight")):
        return ("ones",)
    if name.endswith("bias"):
        return ("zeros",)
    if name == "visual.conv1.weight":
        return ("normal", (3 * d["vision_patch_size"] ** 2) ** -0.5)
    if name.endswith("positional_embedding"):
        return ("normal", 0.01)
    if name in ("visual.class_embedding", "visual.proj", "token_embedding.weight", "text_projection"):
        return ("normal", 0.02)
    if name.endswith(("in_proj_weight", "out_proj.weight", "c_fc.weight", "c_proj.weight")):
        return ("normal", shape[1] ** -0.5)
    raise KeyError(f"no initialiser for CLIP tensor {name}")


def _vqgan_scale(name: str, shape, d: dict):
    if name == "quantize.embedding.weight":
        return ("normal", 1.0)
    if ".norm" in name:  # norm1, norm2, an attention block's norm, norm_out
        return ("ones",) if name.endswith("weight") else ("zeros",)
    if name.endswith("bias"):
        return ("zeros",)
    return ("normal", (shape[1] * shape[2] * shape[3]) ** -0.5)


def _generator(seed: int, name: str, device):
    key = int.from_bytes(hashlib.sha256(f"portbench-weights:{seed}:{name}".encode()).digest()[:8], "big")
    return torch.Generator(device=device).manual_seed(key % 2 ** 63)


def _fill(module: torch.nn.Module, rule, d: dict, gen, device) -> dict:
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    kinds = {k: rule(k, s, d) for k, s in shapes.items()}
    keys = [k for k in shapes if kinds[k][0] == "normal"]
    sizes = [torch.Size(shapes[k]).numel() for k in keys]
    flat = torch.randn((sum(sizes),), generator=gen, device=device, dtype=torch.float32)
    out = {k: part.view(shapes[k]).mul_(kinds[k][1]) for k, part in zip(keys, flat.split(sizes))}
    for k, s in shapes.items():
        if kinds[k][0] == "ones":
            out[k] = torch.ones(s, device=device)
        elif kinds[k][0] == "zeros":
            out[k] = torch.zeros(s, device=device)
    return {k: out[k] for k in shapes}


def make(settings: dict, seed: int, device) -> dict:
    """{model name: state dict} for every tower of ``settings`` (a cell's
    reference settings) and, for the VQGAN drawer, {"vqgan": ...}."""
    out = {}
    for name in settings["clip_models"]:
        d = settings["towers"][name]
        with torch.device("meta"):
            module = CLIP(d)
        out[name] = _fill(module, _clip_scale, d, _generator(seed, name, device), device)
    if settings["drawer"] == "vqgan":
        d = settings["vqgan_dims"]
        with torch.device("meta"):
            module = VQGAN(d)
        out["vqgan"] = _fill(module, _vqgan_scale, d, _generator(seed, "vqgan", device), device)
    return out
