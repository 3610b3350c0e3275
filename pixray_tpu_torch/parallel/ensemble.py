"""Perceptor-ensemble placement on the mesh's ``model`` axis (port of
``pixray_tpu/parallel/ensemble.py``).

With P perceptors on a (data=D, model=M) mesh, member ``p`` runs on the
ranks of model index ``p % M`` in ceil(P/M) rounds, and each of those ranks
scores it on its data chunk of every bank; per-prompt losses are partial
sums over the chunk divided by the GLOBAL cut count, so their sum over the
world is the sequential path's mean.  Every rank still renders every bank
(the warp is cheap); only a rank's own members' towers run there.

The JAX package needs ``switch_placed`` (a ``lax.switch`` on the model
index with a custom VJP) to get past its varying-axis type checker.  It is
not ported: a rank that runs only its own members back-propagates its own
partial loss through its own towers to the replicated latent, and the
latent's gradient is then summed over the world (``engine/step.py``):
that is the same transpose.  Image-prompt pair terms gather the member's
prompt-image embeddings over the data group (:class:`mesh.GatherRows`).

``ensemble_scores`` keeps the JAX call's shape (padded per-kind tables,
deduplicated job batches, pair jobs), and the engine's step scores its
placed towers through it (``engine/step.py``), on banks every rank renders
itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pixray_tpu_torch.ops.grad import l2_normalize, replace_grad
from pixray_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, GatherRows, SumOver, shard_cutout_batch


def ensemble_active(mesh, n_perceptors: int) -> bool:
    """Member-per-group placement engages: a model axis > 1 and > 1 perceptors."""
    return mesh is not None and int(mesh.shape.get(MODEL_AXIS, 1)) > 1 and n_perceptors > 1


def owner(p: int, mesh) -> int:
    """The model index that scores member ``p``."""
    return p % int(mesh.shape[MODEL_AXIS])


@dataclass
class EnsembleMember:
    """One ensemble member: ``image_fn(variables, (n, ...) batch) -> (n, D)``.

    ``affine_fn``: for a tower that folds its input preprocessing into its
    first layer (the port's, ``Perceptor.image_fn``), a whole batch → that
    preprocessing; a chunk is then encoded as ``image_fn(variables, chunk,
    affine_fn(batch))``, stretched by the whole batch's range as the
    sequential path stretches it.  None: ``image_fn(variables, chunk)``."""

    name: str
    image_fn: Callable
    out_dim: int
    affine_fn: Callable | None = None

    def encode(self, variables, batch, rows):
        """``rows`` of ``batch`` (all of it, or a chunk) → embeddings."""
        if self.affine_fn is None:
            return self.image_fn(variables, rows)
        return self.image_fn(variables, rows, self.affine_fn(batch))


def pad_table(table, l_max: int, d_max: int):
    """A PromptTable as (l_max, d_max), (l_max,), (l_max,) float32 tensors
    on its device: padding rows have weight 0 (zero loss and gradient) and
    stop -inf, and zero embeddings (``l2_normalize`` is eps-guarded)."""
    dev = table.embeds.device
    e = torch.zeros((l_max, d_max), dtype=torch.float32, device=dev)
    w = torch.zeros((l_max,), dtype=torch.float32, device=dev)
    s = torch.full((l_max,), -np.inf, dtype=torch.float32, device=dev)
    n, d = int(table.embeds.shape[0]), int(table.embeds.shape[1])
    if n:
        e[:n, :d] = table.embeds.float()
        w[:n] = table.weights.float()
        s[:n] = table.stops.float()
    return e, w, s


def _spherical(x, e):
    cos = torch.clamp(l2_normalize(x.float(), dim=-1) @ l2_normalize(e.float(), dim=-1).T, -1.0, 1.0)
    chord = torch.sqrt(torch.clamp(2.0 - 2.0 * cos, min=1e-12))
    return torch.square(torch.arcsin(chord / 2.0)) * 2.0


def _partial_pair_loss(x_local, e_all, weight: float, n_total: int):
    """A chunk's share of ``prompts.single_prompt_loss``: the spherical
    distances of (chunk × all prompt-image) pairs summed, over the GLOBAL
    pair count."""
    sign = float(np.sign(weight))
    return abs(weight) * torch.sum(_spherical(x_local, e_all)) * sign / (n_total * e_all.shape[0])


def _partial_prompt_losses(emb_local, embeds, weights, stops, n_total: int):
    """A chunk's share of ``prompts.prompt_losses``: the same math summed
    over the chunk and divided by the GLOBAL cut count."""
    d = emb_local.shape[-1]
    dists = _spherical(emb_local, embeds[:, :d]) * torch.sign(weights)[None, :]
    clamped = replace_grad(dists, torch.maximum(dists, stops[None, :]))
    return torch.abs(weights) * torch.sum(clamped, dim=0) / n_total


def ensemble_scores(mesh, members: list[EnsembleMember], job_batches: dict, job_tables: dict, variables_list,
                    want_iii_of: int | None = None, pair_jobs: dict | None = None, reduce: bool = True):
    """Score every (member, job) pair, one member per model group.

    job_batches: {kind: [per-member (N, ...) batch]}, whole on every rank; N
    a multiple of the data-axis size.  job_tables: {kind: [per-member
    PromptTable]}.  variables_list: per-member weights handed to
    ``image_fn``.  pair_jobs: {kind: ([per-member batch], [per-member
    weight])}, image-prompt terms: the batch's chunk embeddings gathered
    over the data group, paired with the member's chunk of 'main'; weight 0
    skips the member.  want_iii_of: the member whose whole 'main' batch to
    encode (the engine's ``embeds``), or None.

    Returns ({kind: (P, Lmax) per-prompt losses, (P, 1) per pair kind},
    iii or None): the rows summed over the mesh, whose backward is the
    identity, so each rank's gradients are its own part, to be summed over
    the mesh by the caller.  ``reduce=False`` leaves each rank's part of
    the rows (zero for the members it does not score), for a caller that
    sums them with the gradient in one collective, as the engine's step does.
    """
    pair_jobs = pair_jobs or {}
    n_members = len(members)
    d_size = int(mesh.shape[DATA_AXIS])
    kinds = [k for k, tables in job_tables.items() if any(t.size for t in tables)]
    pair_kinds = [k for k, (_, ws) in pair_jobs.items() if any(w != 0.0 for w in ws)]
    n_total = int(job_batches["main"][0].shape[0])
    assert n_total % d_size == 0, "cutout count must be padded to the data-axis size"
    for k in pair_kinds:
        for b in pair_jobs[k][0]:
            assert int(b.shape[0]) == n_total, f"pair job {k}: batch size {b.shape[0]} != main {n_total}"
    device = job_batches["main"][0].device
    d_max = max(m.out_dim for m in members)
    l_max = {k: max(t.size for t in job_tables[k]) for k in kinds}
    tables = {}
    for k in kinds:
        packed = [pad_table(t, l_max[k], d_max) for t in job_tables[k]]
        tables[k] = tuple(torch.stack(a).to(device) for a in zip(*packed))

    rows = {k: [torch.zeros((l_max[k],), device=device) for _ in members] for k in kinds}
    rows.update({k: [torch.zeros((1,), device=device) for _ in members] for k in pair_kinds})
    for p in range(n_members):
        if owner(p, mesh) != mesh.model_index:
            continue
        cache = {}  # a batch aliased by several kinds is encoded once

        def emb(batch):
            if id(batch) not in cache:
                cache[id(batch)] = members[p].encode(variables_list[p], batch, shard_cutout_batch(batch, mesh))
            return cache[id(batch)]

        for k in kinds:
            e, w, s = (t[p] for t in tables[k])
            rows[k][p] = _partial_prompt_losses(emb(job_batches[k][p]), e, w, s, n_total)
        for k in pair_kinds:
            batches, weights = pair_jobs[k]
            if weights[p] == 0.0:
                continue
            e_all = GatherRows.apply(emb(batches[p]), mesh.data_index, d_size, mesh.data_group)
            rows[k][p] = _partial_pair_loss(emb(job_batches["main"][p]), e_all, float(weights[p]),
                                            n_total).reshape(1)
    out = {k: SumOver.apply(torch.stack(v), mesh.group) if reduce else torch.stack(v) for k, v in rows.items()}
    iii = None
    if want_iii_of is not None:  # one replicated encode of the member's whole main batch
        p, batch = want_iii_of, job_batches["main"][want_iii_of]
        iii = members[p].encode(variables_list[p], batch, batch).float()
    return out, iii
