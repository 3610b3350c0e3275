"""The optimization step (port of ``build_loss_fn`` and ``_build_step_core``
in ``pixray_tpu/engine/step.py``, for the terms the ported slices have).

    synth → [flatten alpha] → per perceptor: pool → cutouts → encode →
    prompt losses;  + init-weight and transparency terms
    then grad → Adam → LR scale → drawer clamp.

Random draws of a step come in a ``draws`` dict (see ``loss_fn``), so a
caller can replay another implementation's draws.  The latent ``z`` is a
tensor or a dict of tensors (``engine/latent.py``); gradients, the
optimizer and ``batches`` accumulation go leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.latent import leaves, ravel, tree_map, unflatten
from pixray_tpu_torch.engine.prompts import PromptTable, prompt_losses
from pixray_tpu_torch.ops.grad import spherical_dist_loss


@dataclass
class PerceptorSpec:
    name: str
    cut_size: int
    image_fn: Any  # (N, 3, S, S) cutouts → (N, D) normalized embeddings
    table: PromptTable


@dataclass
class StepConfig:
    drawer: Any
    drawer_params: dict
    perceptors: list[PerceptorSpec]
    batches: int
    transparent: bool = False
    transparent_weight: float = 0.0
    init_weight: float | None = None
    init_weight_dist: float = 0.0
    init_weight_cos: float = 0.0
    z_orig_flat: Any = None
    compute_dtype: Any = None  # post-warp epilogue dtype (None = float32)
    names: list = field(default_factory=list)


def loss_fn(cfg: StepConfig, z, iteration: int, draws: dict):
    """→ (total, (values (L,), img)).  Loss-term names land in ``cfg.names``.

    draws: {"fill": float, "perceptors": [per-perceptor dict with
    "transforms", "jitter", "noise" as ``render_cutouts`` takes them]}."""
    names, values = [], []

    def add(name, value):
        names.append(name)
        values.append(value)

    img = cfg.drawer.synth(cfg.drawer_params, z)
    fill_color = float(draws["fill"])
    alpha = None
    if img.shape[-1] == 4:
        colors = img[..., :3]
        if cfg.transparent:
            alpha = img[..., 3:4]
            img = alpha * colors + (1 - alpha) * fill_color
        else:
            img = colors

    reflect_padding = iteration % 2 == 0
    for spec, pd in zip(cfg.perceptors, draws["perceptors"]):
        work = C.pool_to_work(img, spec.cut_size)
        cutouts = C.render_cutouts(
            work, pd["transforms"], spec.cut_size, reflect_padding=reflect_padding,
            fill_color=fill_color, jitter=pd["jitter"], noise=pd["noise"],
            compute_dtype=cfg.compute_dtype,
        )
        iii = spec.image_fn(cutouts)
        pl = prompt_losses(iii, spec.table)
        for i in range(spec.table.size):
            add(f"{spec.name}:prompt{i}", pl[i])

    if cfg.init_weight or cfg.init_weight_dist or cfg.init_weight_cos:
        z_flat, z0 = ravel(z), cfg.z_orig_flat
    if cfg.init_weight:
        add("init_weight", torch.mean(spherical_dist_loss(z_flat[None], z0[None])) * cfg.init_weight)
    if cfg.init_weight_dist:
        add("init_weight_dist", torch.mean((z_flat - z0) ** 2) * cfg.init_weight_dist / 2)
    if cfg.init_weight_cos:
        cos = torch.nn.functional.cosine_similarity(z_flat[None], z0[None], dim=-1, eps=1e-8)
        add("init_weight_cos", torch.mean(1.0 - cos) * cfg.init_weight_cos)
    if alpha is not None and cfg.transparent_weight != 0:
        add("transparent", cfg.transparent_weight * torch.mean(alpha))

    cfg.names[:] = names
    vals = torch.stack(values) if values else torch.zeros((0,), device=img.device)
    return vals.sum(), (vals, img)


def loss_and_grads(cfg: StepConfig, z, iteration: int, batch_draws: list[dict]):
    """Gradients of the loss w.r.t. each leaf of ``z``, summed over the
    batches (one draws dict each), and the first batch's (total, values, img)."""
    if len(batch_draws) != cfg.batches:
        raise ValueError(f"{len(batch_draws)} draws for {cfg.batches} batches")
    params = [p.detach().requires_grad_(True) for p in leaves(z)]
    zp = unflatten(z, params)
    grads = None
    first = None
    for draws in batch_draws:
        total, (vals, img) = loss_fn(cfg, zp, iteration, draws)
        gs = torch.autograd.grad(total, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        grads = gs if grads is None else [a + b for a, b in zip(grads, gs)]
        if first is None:
            first = (total.detach(), vals.detach(), img.detach())
    return unflatten(z, grads), first


def train_step(cfg: StepConfig, optimizer, z, opt_state, iteration: int, lr_scale: float,
               batch_draws: list[dict]):
    """One optimizer step.  ``batch_draws`` holds one draws dict per batch;
    gradients sum over the batches, metrics come from the first.  The LR
    scale multiplies every group's update alike.

    Returns (z, opt_state, total, values, img)."""
    grads, first = loss_and_grads(cfg, z, iteration, batch_draws)
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state)
        z = cfg.drawer.clip_params(tree_map(lambda p, u: p.detach() + u * lr_scale, z, updates))
    return (z, opt_state, *first)
