"""Random weights from the seed, made on the device in a few large calls.

The scales are those of the program's own seeded initialisation (flax's
initialisers): lecun-normal kernels and convolutions (standard deviation
1/sqrt(fan-in)), normal(0.02) embeddings and projections, normal(0.01)
positional tables, unit scales and zero shifts in every norm, zero biases.
Each model's rule comes from the plain reference: a CLIP model's from
``reference/clip.py`` (the text tower's) and its image tower's kind
(``reference/towers/<kind>.py``), a drawer's own model's from its
``reference/drawers/<drawer>.py`` (``model`` and ``init_rule``).  One
normal draw in float32 covers every random tensor of a model, in its
state dict's order, from one device generator seeded from ``seed`` and
the model's name, so the same seed gives the same weights on the same
device.  Names and shapes come from the reference's modules, which carry
the checkpoints' state-dict names.
"""

from __future__ import annotations

import functools
import hashlib
import importlib

import torch

from portbench.reference import clip as RCLIP


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
    reference settings) and, for a drawer with a model of its own, {its
    key: ...}."""
    out = {}
    bench_dir = settings.get("bench_dir")
    for name in settings["clip_models"]:
        d = settings["towers"][name]
        with torch.device("meta"):
            module = RCLIP.CLIP(d, bench_dir)
        rule = functools.partial(RCLIP.init_rule, bench_dir=bench_dir)
        out[name] = _fill(module, rule, d, _generator(seed, name, device), device)
    drawer = importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}")
    if hasattr(drawer, "model"):
        with torch.device("meta"):
            key, module, d = drawer.model(settings)
        out[key] = _fill(module, drawer.init_rule, d, _generator(seed, key, device), device)
    return out
