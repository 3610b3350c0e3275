"""Prompt embedding tables and the batched spherical prompt loss (port of
``pixray_tpu/engine/prompts.py``): target images, text, vector, label and
noise prompts in the main table; spot and spot_off text prompts in their
own; under ``--animation_dir`` the target images in a table of their own,
one row per animation frame.

For an image-embedding batch ``iii`` and each table row:

    dist = spherical_dist(iii, embed) * sign(weight)
    loss = |weight| * mean(replace_grad(dist, max(dist, stop)))
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from pixray_tpu_torch.ops.grad import l2_normalize, replace_grad
from pixray_tpu_torch.prompt import parse_prompt

IMAGENET_TEMPLATES = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]


@dataclass
class PromptTable:
    """Stacked prompt embeddings for one perceptor."""

    embeds: torch.Tensor  # (P, D)
    weights: torch.Tensor  # (P,)
    stops: torch.Tensor  # (P,)

    @classmethod
    def from_rows(cls, rows, dim: int, device="cpu"):
        """rows: list of (embed (D,) or (K, D), weight, stop)."""
        embeds, weights, stops = [], [], []
        for embed, weight, stop in rows:
            for row in np.atleast_2d(np.asarray(embed, dtype=np.float32)):
                embeds.append(row)
                weights.append(weight)
                stops.append(stop)
        if not embeds:
            return cls(torch.zeros((0, dim), device=device), torch.zeros((0,), device=device),
                       torch.zeros((0,), device=device))
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return cls(t(np.stack(embeds)), t(weights), t(stops))

    @property
    def size(self) -> int:
        return int(self.embeds.shape[0])


def prompt_losses(iii, table: PromptTable):
    """(P,) per-prompt losses of an (N, D) embedding batch against a table."""
    if table.size == 0:
        return torch.zeros((0,), dtype=torch.float32, device=iii.device)
    emb = l2_normalize(table.embeds, dim=-1)
    x = l2_normalize(iii, dim=-1)
    # chord length via cosine: ||x - e||^2 = 2 - 2 x·e   (both unit)
    cos = torch.clamp(x @ emb.T, -1.0, 1.0)
    chord = torch.sqrt(torch.clamp(2.0 - 2.0 * cos, min=1e-12))
    dists = torch.square(torch.arcsin(chord / 2.0)) * 2.0
    dists = dists * torch.sign(table.weights)[None, :]
    clamped = replace_grad(dists, torch.maximum(dists, table.stops[None, :]))
    return torch.abs(table.weights) * torch.mean(clamped, dim=0)


def single_prompt_loss(iii, embed, weight=1.0):
    """The image-prompt loss: the mean spherical distance over all (N, M)
    pairs of two embedding batches, times ``weight``."""
    x = l2_normalize(iii, dim=-1)
    e = l2_normalize(embed, dim=-1)
    cos = torch.clamp(x @ e.T, -1.0, 1.0)
    chord = torch.sqrt(torch.clamp(2.0 - 2.0 * cos, min=1e-12))
    dists = torch.square(torch.arcsin(chord / 2.0)) * 2.0
    sign = 1.0 if weight > 0 else (-1.0 if weight < 0 else 0.0)
    return abs(weight) * torch.mean(dists * sign)


def find_vector_file(name: str):
    """Locate a vector-prompt JSON by name (``$PIXRAY_TPU_VECTORS``, ``vectors/``,
    or the repository's ``vectors/``)."""
    if "json" in name:
        return name if os.path.exists(name) else None
    repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for base in (os.environ.get("PIXRAY_TPU_VECTORS", ""), "vectors", os.path.join(repo_dir, "vectors")):
        if base and os.path.exists(os.path.join(base, f"{name}.json")):
            return os.path.join(base, f"{name}.json")
    return None


def build_prompt_tables(args, perceptors, device="cpu", target_image_paths=None):
    """(tables, spot_tables, spot_off_tables, target_tables), each a
    {perceptor name: PromptTable}.

    The main table's rows in order: the target images (``(path, weight,
    stop)`` in ``target_image_paths``, each encoded once; under
    ``args.animation_dir`` they fill the target table instead), the text prompts
    ('=' prefix pools the text features at the last content token), the
    vector prompts (stored embeddings, weights scaled by 0.1), the labels
    (the normalized mean of ``IMAGENET_TEMPLATES``), then the noise prompts
    (``noise_prompt_seeds``, rows of the last perceptor only)."""
    rows = {p.name: [] for p in perceptors}
    spot_rows = {p.name: [] for p in perceptors}
    spot_off_rows = {p.name: [] for p in perceptors}
    target_rows = {p.name: [] for p in perceptors}

    for p in perceptors:
        for path, weight, stop in target_image_paths or []:
            from pixray_tpu_torch.io.images import load_image_for_perceptor

            img = load_image_for_perceptor(path, p.input_resolution)
            out = rows if args.animation_dir is None else target_rows
            out[p.name].append((p.encode_image(img[None]).cpu().numpy(), weight, stop))

    for prompt in args.prompts or []:
        txt, weight, stop = parse_prompt(prompt)
        use_stops = txt.startswith("=")
        if use_stops:
            txt = txt[1:]
        for p in perceptors:
            embed = p.encode_text_with_stops(txt) if use_stops else p.encode_text(txt)
            rows[p.name].append((embed.cpu().numpy(), weight, stop))

    for vect_prompt in args.vector_prompts or []:
        name, weight, stop = parse_prompt(vect_prompt)
        weight = 0.1 * weight
        path = find_vector_file(name)
        if path is None:
            print(f"WARNING: vector prompt file for {name!r} not found, skipping")
            continue
        with open(path) as f:
            vect_table = json.load(f)
        for p in perceptors:
            if p.name not in vect_table:
                print(f"WARNING: no vector for {p.name} in {name}! Continuing without it.")
                continue
            rows[p.name].append((np.asarray(vect_table[p.name], np.float32), weight, stop))

    for prompts, out in ((args.spot_prompts, spot_rows), (args.spot_prompts_off, spot_off_rows)):
        for prompt in prompts or []:
            txt, weight, stop = parse_prompt(prompt)
            for p in perceptors:
                out[p.name].append((p.encode_text(txt).cpu().numpy(), weight, stop))

    for label in args.labels or []:
        txt, weight, stop = parse_prompt(label)
        texts = [template.format(txt) for template in IMAGENET_TEMPLATES]
        for p in perceptors:
            embeds = p.encode_text(texts).cpu().numpy()
            embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
            mean_embed = embeds.mean(axis=0)
            rows[p.name].append((mean_embed / np.linalg.norm(mean_embed), weight, stop))

    if args.noise_prompt_seeds:
        last = perceptors[-1]
        for seed, weight in zip(args.noise_prompt_seeds, args.noise_prompt_weights):
            embed = np.random.default_rng(seed).standard_normal((1, last.output_dim)).astype(np.float32)
            rows[last.name].append((embed, weight, float("-inf")))

    def tables(rdict):
        return {p.name: PromptTable.from_rows(rdict[p.name], p.output_dim, device) for p in perceptors}

    return tables(rows), tables(spot_rows), tables(spot_off_rows), tables(target_rows)
