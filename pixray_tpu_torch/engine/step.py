"""The optimization step (port of ``build_loss_fn``, ``_build_step_core``
and ``build_multi_step`` in ``pixray_tpu/engine/step.py``, for the terms
the ported slices have).

    synth → filters → [flatten alpha] → per perceptor: pool → cutouts →
    encode → prompt losses (+ the animation frame's target row), + the
    spot / spot_off banks (the masked work canvas) and the image-prompt
    banks (each prompt image, pooled once per run; under animation one
    bank, of the frame's image) on the main cuts' geometry;  +
    image-label, init-weight and transparency terms, then the custom
    losses;  then grad → optimizer → LR scale → drawer clamp.

Random draws of a step come in a ``draws`` dict (see :func:`pack_step`),
so a caller can replay another implementation's draws.  The host packs
them into the step's inputs, one float32 buffer per step: per batch, one
block of parameter rows for all the perceptors' banks (per perceptor its
main bank, then its spot, spot_off and image-prompt banks;
``cutouts.pack_cutouts``: the cut geometry, the padding mode of the
step's parity, jitter, noise factor and the fill), then an int32 tail of
the iteration, the animation frame's index, each batch's filter shifts
and each batch's custom-loss draws (a loss that draws, as ``style``
does, declares them with ``draw_layout``; float32 draws ride in the tail
as their bits); and the noise planes.  The step itself reads only those and
device state (the frame's image prompt and target row are picked from
tensors stacked once per run by that index), so it runs as one captured
CUDA graph: :class:`StepBlock` holds the inputs of ``n`` steps at fixed
addresses and runs the ``n`` steps as one replay (the counterpart of the
JAX package's ``lax.scan`` block).  The latent
``z`` is a tensor or a dict of tensors (``engine/latent.py``); gradients,
the optimizer and ``batches`` accumulation go leaf by leaf, and the step
writes the new latent and optimizer state into the old ones.

Under a mesh (``StepConfig.mesh``, ``parallel/mesh.py``) every rank
renders every bank in full and encodes its data chunk of it, stretched
by the whole bank's range; the per-cut terms are the chunk's shares
(``parallel/ensemble.py``; under ensemble placement ``ensemble_scores``
scores only the rank's own towers), and the other terms come from rank 0
alone.  One sum over
the mesh of the gradient and the values ends the step, so every rank
takes the same optimizer step on the same bits.  FSDP gathers the
towers' weights around each batch's forward and backward.

The step's layer calls (each tower's ``image_fn``, the drawer's
``synth``, each cutout bank) go through ``profiling.ranged``: a capture
made while the layer ranges are on times each on the device
(``engine/profiling.py``); otherwise they are plain calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import contextlib
import gc
import threading

import torch

from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine import profiling as P
from pixray_tpu_torch.engine.latent import leaves, ravel, tree_map, unflatten
from pixray_tpu_torch.engine.optimizers import state_tensors
from pixray_tpu_torch.engine.prompts import PromptTable, prompt_losses, single_prompt_loss
from pixray_tpu_torch.ops import attention, cuda_strokes, cuda_warp
from pixray_tpu_torch.ops.cuda_warp import PARAM_STRIDE, unpack_params
from pixray_tpu_torch.ops.grad import spherical_dist_loss
from pixray_tpu_torch.ops.warp_batch import bwd_prec
from pixray_tpu_torch.parallel import ensemble as E
from pixray_tpu_torch.parallel import mesh as M


@dataclass
class PerceptorSpec:
    name: str
    cut_size: int
    image_fn: Any  # (N, 3, S, S) cutouts → (N, D) normalized embeddings
    table: PromptTable
    spot_table: PromptTable | None = None
    spot_off_table: PromptTable | None = None
    spot_keep_on: Any = None  # (S, S) float32 masks on the step's device, or None
    spot_keep_off: Any = None
    image_prompts: Any = None  # (K, S, S, 3) prompt images pooled to the work canvas, or None
    image_prompt_weight: float | None = None
    target_table: PromptTable | None = None  # the animation's target images, one row per frame
    image_prompt_frame: bool = False  # animation: one image-prompt bank, of the frame's image
    affine_fn: Any = None  # a bank → its range stretch (``Perceptor.preprocess_affine``), for a mesh's chunks

    @property
    def spot_banks(self) -> tuple[bool, bool]:
        return (self.spot_table is not None and self.spot_table.size > 0,
                self.spot_off_table is not None and self.spot_off_table.size > 0)

    @property
    def n_image_prompts(self) -> int:
        """Image-prompt banks per step: one per prompt image, or under animation the frame's one."""
        if self.image_prompts is None:
            return 0
        return 1 if self.image_prompt_frame else int(self.image_prompts.shape[0])

    @property
    def banks(self) -> int:
        """Cutout banks per step: the main one, spot, spot_off, one per image prompt."""
        return 1 + sum(self.spot_banks) + self.n_image_prompts


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
    init_weight_pix: float = 0.0
    image_label_weight: float = 1.0
    image_prompt_shuffle: bool = False
    z_orig_flat: Any = None
    init_image: Any = None  # (H, W, 3) float32, the last init image, for init_weight_pix
    z_labels: list = field(default_factory=list)  # the image labels' normalized mean latent
    compute_dtype: Any = None  # post-warp epilogue dtype (None = float32)
    warp_prec: str = "highest"  # K1's rung (config/precision.py)
    warp_bwd: str = "bf16"  # PIXRAY_TPU_WARP_BWD_PREC's value; K2's rung is bwd_prec of both
    filters: list = field(default_factory=list)  # [(filter, weight)]
    custom_losses: list = field(default_factory=list)  # [(loss, weight)]
    loss_globals: dict = field(default_factory=dict)  # the losses' add_globals
    loss_layouts: list = field(default_factory=list)  # per custom loss: its draws' [(name, shape, dtype)]
    args: Any = None  # the settings, which the custom losses read
    names: list = field(default_factory=list)
    mesh: Any = None  # parallel.mesh.Mesh, or None
    ensemble: bool = False  # perceptor-ensemble placement on the mesh's model axis
    fsdp: list = field(default_factory=list)  # parallel.mesh.ShardedWeights of the towers (FSDP)
    loss_outputs: dict = field(default_factory=dict)  # custom loss → its term count, learnt off the lead rank


# the kernels' launch counters, which a replay advances by what its capture recorded
LAUNCH_COUNTERS = (cuda_warp.LAUNCHES, cuda_strokes.LAUNCHES, attention.LAUNCHES)
_CAPTURE_LOCK = threading.Lock()
# one warm-up stream per device, as torch.cuda.graph keeps one capture
# stream: cuBLAS caches a workspace (32 MiB on Hopper) for every (handle,
# stream) pair it meets, so a new stream per capture grows a server's
# memory with every request
_WARMUP_STREAMS: dict = {}


def bank_rows(cfg: StepConfig, num_cuts: int) -> list[int]:
    """Parameter rows per perceptor and batch: ``num_cuts`` for each of its banks."""
    return [num_cuts * spec.banks for spec in cfg.perceptors]


def loss_draw_words(cfg: StepConfig) -> int:
    """32-bit words of one batch's custom-loss draws."""
    return sum(int(torch.Size(shape).numel()) for layout in cfg.loss_layouts for _n, shape, _d in layout)


def input_sizes(cfg: StepConfig, cut_counts):
    """(float32 words of one step's parameter rows, int32 words of its tail:
    the iteration, the animation frame's index, then (batches, filters, 2)
    shifts, then per batch the custom losses' draws); ``cut_counts``: rows
    per perceptor (:func:`bank_rows`)."""
    return (cfg.batches * sum(cut_counts) * PARAM_STRIDE,
            2 + cfg.batches * (len(cfg.filters) * 2 + loss_draw_words(cfg)))


def _loss_draw_views(cfg: StepConfig, words):
    """Per custom loss, {name: view} of one batch's int32 draw words, float32 draws viewed as float32."""
    out, off = [], 0
    for layout in cfg.loss_layouts:
        views = {}
        for name, shape, dtype in layout:
            n = int(torch.Size(shape).numel())
            view = words[off:off + n]
            views[name] = (view.view(torch.float32) if dtype == torch.float32 else view).view(shape)
            off += n
        out.append(views)
    return out


def split_inputs(cfg: StepConfig, buf, cut_counts):
    """Views of a (..., rows + tail) float32 step buffer: the rows (...,
    batches, R, PARAM_STRIDE) and the int32 tail (..., 2 + batches * filters * 2)."""
    n_rows, _ = input_sizes(cfg, cut_counts)
    lead = tuple(buf.shape[:-1])
    rows = buf[..., :n_rows].view(*lead, cfg.batches, sum(cut_counts), PARAM_STRIDE)
    return rows, buf[..., n_rows:].view(torch.int32)


def pack_step(cfg: StepConfig, batch_draws: list[dict], iteration: int, out_rows, out_ints, anim_index: int = 0):
    """Pack one step's draws into its host inputs: the parameter rows
    ``out_rows`` (batches, sum of the banks' cut counts, PARAM_STRIDE), per
    batch each perceptor's banks in turn (``cutouts.draw_banks``: the main
    bank, then spot, spot_off and the image prompts, which carry the main
    cuts' inverses, modes and fill, no jitter and their own noise factors),
    every row carrying the batch's fill; and the int32 tail ``out_ints``:
    the iteration, the animation frame's index, then each batch's filter
    shifts.

    batch_draws: one dict per batch, {"fill": float, "filters": [(rand_h,
    rand_w) per filter] (absent without filters), "perceptors": [per
    perceptor {"transforms", "jitter", "noise"} as
    ``cutouts.render_cutouts`` takes them, and the keys of
    ``cutouts.draw_step_cutouts`` for the other banks], "losses": [per
    custom loss {name: host tensor} of its ``draw_layout``] (absent when
    no loss draws)}.  The zoom cuts pad by reflection on even iterations."""
    if len(batch_draws) != cfg.batches:
        raise ValueError(f"{len(batch_draws)} draws for {cfg.batches} batches")
    out_ints[0], out_ints[1] = iteration, anim_index
    n_shifts = cfg.batches * len(cfg.filters) * 2
    shifts = out_ints[2:2 + n_shifts].view(cfg.batches, len(cfg.filters), 2)
    loss_words = out_ints[2 + n_shifts:].view(cfg.batches, loss_draw_words(cfg))
    for b, draws in enumerate(batch_draws):
        off = 0
        for pd in draws["perceptors"]:
            for transforms, jitter, noise in C.draw_banks(pd):
                n = sum(t.shape[0] for t in transforms)
                C.pack_cutouts(transforms, reflect_padding=iteration % 2 == 0, fill_color=draws["fill"],
                               jitter=jitter, facs=None if noise is None else noise[0],
                               out=out_rows[b, off:off + n])
                off += n
        if off != out_rows.shape[1]:
            raise ValueError(f"the draws hold {off} cuts, the rows {out_rows.shape[1]}")
        filter_draws = draws.get("filters", [])
        if len(filter_draws) != len(cfg.filters):
            raise ValueError(f"{len(filter_draws)} filter draws for {len(cfg.filters)} filters")
        for i, pair in enumerate(filter_draws):
            shifts[b, i, 0], shifts[b, i, 1] = int(pair[0]), int(pair[1])
        if loss_words.shape[1]:
            for views, draws_i in zip(_loss_draw_views(cfg, loss_words[b]), draws["losses"]):
                for name, view in views.items():
                    view.copy_(draws_i[name].reshape(view.shape))


def step_inputs(cfg: StepConfig, buf, planes, cut_counts, skip=frozenset()):
    """The step's inputs, per batch {"fill", "iteration", "anim_index": ()
    tensors, "filters": (filters, 2) int32, "perceptors": [per perceptor {"params":
    (R, PARAM_STRIDE), "planes": three (R, S, S) or None}], "losses": [per
    custom loss {name: its draw}], "skip": the custom losses left out},
    as views of the step's buffer ``buf`` on the step's device and of
    ``planes`` (per batch, per perceptor); ``cut_counts``: rows R per
    perceptor, bank after bank; ``skip``: indices of custom losses whose
    gate is off at every step these inputs serve (their term is 0)."""
    rows, ints = split_inputs(cfg, buf, cut_counts)
    n_shifts = cfg.batches * len(cfg.filters) * 2
    shifts = ints[2:2 + n_shifts].view(cfg.batches, len(cfg.filters), 2)
    loss_words = ints[2 + n_shifts:].view(cfg.batches, loss_draw_words(cfg))
    out = []
    for b, batch_planes in enumerate(planes):
        off, perceptors = 0, []
        for zs, n in zip(batch_planes, cut_counts):
            perceptors.append({"params": rows[b, off:off + n], "planes": zs})
            off += n
        out.append({"fill": unpack_params(rows[b])["fill"][0], "iteration": ints[0], "anim_index": ints[1],
                    "filters": shifts[b], "perceptors": perceptors,
                    "losses": _loss_draw_views(cfg, loss_words[b]), "skip": skip})
    return out


def draws_to_inputs(cfg: StepConfig, batch_draws: list[dict], iteration: int, device, anim_index: int = 0,
                    skip=frozenset()):
    """One eager step's inputs from its draws: packed on the host (pinned
    for the card) and copied to ``device`` in one copy; the draws' own
    planes (a perceptor's banks' planes concatenated)."""
    cuts = [sum(t.shape[0] for bank in C.draw_banks(pd) for t in bank[0]) for pd in batch_draws[0]["perceptors"]]
    buf = torch.zeros((sum(input_sizes(cfg, cuts)),), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    pack_step(cfg, batch_draws, iteration, *split_inputs(cfg, buf, cuts), anim_index=anim_index)

    def planes(pd):
        if pd["noise"] is None:
            return None
        noises = [bank[2][1] for bank in C.draw_banks(pd)]
        return tuple(torch.cat([nz[c] for nz in noises]) if len(noises) > 1 else noises[0][c] for c in range(3))

    return step_inputs(cfg, buf.to(device, non_blocking=True),
                       [[planes(pd) for pd in d["perceptors"]] for d in batch_draws], cuts, skip)


def loss_fn(cfg: StepConfig, z, inputs: dict):
    """→ (total, (values (L,), img)) of one batch.  Loss-term names land in
    ``cfg.names``.  inputs: one batch's entry of :func:`step_inputs`."""
    names, values = [], []
    mesh = cfg.mesh
    # under a mesh each rank adds its chunk's share of the per-cut terms;
    # the other terms come once, from the mesh's first rank
    lead = mesh is None or mesh.rank == 0

    def add(name, value):
        names.append(name)
        values.append(value)

    def zeros(n=()):
        return torch.zeros(n, dtype=torch.float32, device=img.device)

    # the iteration as a () device tensor (the vdiff drawer picks its
    # schedule entry by it; the other drawers ignore it)
    img = P.ranged("decoder", cfg.drawer.synth, cfg.drawer_params, z, inputs["iteration"], at=1)

    for i, (filt, weight) in enumerate(cfg.filters):
        img, f_loss = filt(img, inputs["filters"][i])
        add(f"filter:{type(filt).__name__}", weight * f_loss if lead else zeros())

    alpha = None
    if img.shape[-1] == 4:
        colors = img[..., :3]
        if cfg.transparent:
            alpha = img[..., 3:4]
            img = alpha * colors + (1 - alpha) * inputs["fill"]
        else:
            img = colors

    # the losses see each cut size's last main bank channels-last in float32
    # (two towers of one size: the second replaces the first, as in JAX)
    cur_cutouts, rendered = {}, []
    for spec, pd in zip(cfg.perceptors, inputs["perceptors"]):
        banks = _render(cfg, spec, pd, img, inputs)
        if cfg.custom_losses:
            cur_cutouts[spec.cut_size] = banks.main.permute(0, 2, 3, 1).float()
        rendered.append(banks)

    tie = None  # ties the gathered embeddings into every rank's loss (see below)
    if cfg.ensemble:
        # the embeds global costs one replicated encode: only where a loss reads it
        want = bool(cfg.custom_losses) and (lead or len(cfg.loss_outputs) < len(cfg.custom_losses))
        terms, embeds = _placed_terms(cfg, rendered, inputs, want)
    else:
        terms, iii = [], None
        for spec, banks in zip(cfg.perceptors, rendered):
            spec_terms, iii = _scored_terms(cfg, spec, banks, inputs)
            terms += spec_terms
        embeds = iii
        if mesh is not None and cfg.custom_losses:
            # the losses read the last tower's whole batch: its chunks gathered
            # with their gradient; every rank of the data group then runs the
            # gather's backward collective, so each ties it in with weight 0
            embeds = M.GatherRows.apply(iii, mesh.data_index, mesh.shape[M.DATA_AXIS], mesh.data_group)
            tie = embeds.sum() * 0.0
    for name, value in terms:
        add(name, value)

    if cfg.z_labels or cfg.init_weight or cfg.init_weight_dist or cfg.init_weight_cos:
        z_flat, z0 = ravel(z), cfg.z_orig_flat
    for i, z_label in enumerate(cfg.z_labels):
        add(f"image_label{i}",
            torch.mean(spherical_dist_loss(z_flat[None], z_label.reshape(1, -1))) * cfg.image_label_weight
            if lead else zeros())
    if cfg.init_weight:
        add("init_weight", torch.mean(spherical_dist_loss(z_flat[None], z0[None])) * cfg.init_weight
            if lead else zeros())
    if cfg.init_weight_dist:
        add("init_weight_dist", torch.mean((z_flat - z0) ** 2) * cfg.init_weight_dist / 2 if lead else zeros())
    if cfg.init_weight_pix:
        d = img - cfg.init_image
        # |d| with the gradient +1 at 0, as JAX's abs takes it
        add("init_weight_pix", torch.mean(torch.where(d >= 0, d, -d)) * cfg.init_weight_pix / 2
            if lead else zeros())
    if cfg.init_weight_cos:
        cos = torch.nn.functional.cosine_similarity(z_flat[None], z0[None], dim=-1, eps=1e-8)
        add("init_weight_cos", torch.mean(1.0 - cos) * cfg.init_weight_cos if lead else zeros())
    if alpha is not None and cfg.transparent_weight != 0:
        add("transparent", cfg.transparent_weight * torch.mean(alpha) if lead else zeros())

    loss_globals = {"cur_iteration": inputs["iteration"], "embeds": embeds, "fill_color": inputs["fill"]}
    for i, (loss_obj, weight) in enumerate(cfg.custom_losses):
        name = type(loss_obj).__name__
        if i in inputs["skip"]:  # its gate is off at every step of this dispatch: the term is 0
            add(f"loss:{name}", weight * img.new_zeros(()))
            continue
        globals_i = dict(loss_globals, draws=inputs["losses"][i])
        if lead:
            out = loss_obj.get_loss(cur_cutouts, img, cfg.args, globals=globals_i, lossGlobals=cfg.loss_globals)
        else:  # zeros in the lead's place; how many, learnt from one forward
            if i not in cfg.loss_outputs:
                with torch.no_grad():
                    out = loss_obj.get_loss(cur_cutouts, img, cfg.args, globals=globals_i,
                                            lossGlobals=cfg.loss_globals)
                cfg.loss_outputs[i] = len(out) if isinstance(out, (list, tuple)) else None
            count = cfg.loss_outputs[i]
            out = zeros() if count is None else [zeros()] * count
        if isinstance(out, (list, tuple)):
            for j, value in enumerate(out):
                add(f"loss:{name}:{j}", weight * value)
        else:
            add(f"loss:{name}", weight * out)

    cfg.names[:] = names
    vals = torch.stack(values) if values else torch.zeros((0,), device=img.device)
    total = vals.sum()
    return (total if tie is None else total + tie), (vals, img)


@dataclass
class _Banks:
    """One perceptor's banks of a batch: the main one, spot and spot_off
    (None when off), and the image prompts' [(term name, bank)], rendered
    without a gradient; ``n`` rows each."""

    main: Any
    spot: Any
    spot_off: Any
    prompts: list
    n: int


def _render(cfg: StepConfig, spec: PerceptorSpec, pd: dict, img, inputs: dict) -> _Banks:
    """Every bank of ``spec`` in the packed order, through K1 (every rank
    renders every bank in full)."""
    n = pd["params"].shape[0] // spec.banks
    banks = iter(range(spec.banks))

    def bank(src):
        k = next(banks)
        planes = None if pd["planes"] is None else [p[k * n:(k + 1) * n] for p in pd["planes"]]
        return P.ranged("bank", cuda_warp.cutout_bank, src, pd["params"][k * n:(k + 1) * n], spec.cut_size, planes,
                        cfg.compute_dtype, cfg.warp_prec, bwd_prec(cfg.warp_prec, cfg.warp_bwd, spec.cut_size))

    work = C.pool_to_work(img, spec.cut_size)
    main = bank(work)
    spot = bank(work * spec.spot_keep_on[..., None]) if spec.spot_banks[0] else None
    spot_off = bank(work * spec.spot_keep_off[..., None]) if spec.spot_banks[1] else None
    if spec.image_prompt_frame and spec.n_image_prompts:
        frame = torch.remainder(inputs["anim_index"], spec.image_prompts.shape[0]).long().view(1)
        prompt_images = [(spec.image_prompts.index_select(0, frame)[0], "image_prompt_frame")]
    else:
        prompt_images = [(spec.image_prompts[k], f"image_prompt{k}") for k in range(spec.n_image_prompts)]
    with torch.no_grad():  # constant images: forward-only K1 launches
        prompts = [(name, bank(image)) for image, name in prompt_images]
    return _Banks(main, spot, spot_off, prompts, n)


def _target_frame(table: PromptTable, inputs: dict):
    """The animation frame's row index of a target table, picked on the
    device (index_select: indexing by a () tensor syncs, which a captured
    block may not do)."""
    return torch.remainder(inputs["anim_index"], table.size).long().view(1)


def _scored_terms(cfg: StepConfig, spec: PerceptorSpec, banks: _Banks, inputs: dict):
    """One tower's terms, its main embeddings: the whole banks, or under a
    mesh (data parallel, FSDP) the rank's chunk's shares of them."""
    mesh = cfg.mesh

    def table_losses(emb, table):
        if mesh is None or table.size == 0:
            return prompt_losses(emb, table)
        return E._partial_prompt_losses(emb, table.embeds, table.weights, table.stops, banks.n)

    iii = _encode(cfg, spec, banks.main)
    pl = table_losses(iii, spec.table)
    terms = [(f"{spec.name}:prompt{i}", pl[i]) for i in range(spec.table.size)]
    if spec.target_table is not None and spec.target_table.size:
        frame = _target_frame(spec.target_table, inputs)
        terms.append((f"{spec.name}:target_frame", table_losses(iii, spec.target_table).index_select(0, frame)[0]))
    for kind, bank, table in (("spot", banks.spot, spec.spot_table), ("spot_off", banks.spot_off, spec.spot_off_table)):
        if bank is not None:
            sl = table_losses(_encode(cfg, spec, bank), table)
            terms += [(f"{spec.name}:{kind}{i}", sl[i]) for i in range(table.size)]
    weight = 1.0 if spec.image_prompt_weight is None else spec.image_prompt_weight
    for name, bank in banks.prompts:
        with torch.no_grad():
            embed = _encode(cfg, spec, bank)
        if mesh is None:
            terms.append((f"{spec.name}:{name}", single_prompt_loss(iii, embed, weight)))
        else:  # the chunk's pairs with every prompt-image cut
            embed = M.gather_along(embed, 0, mesh.data_index, mesh.shape[M.DATA_AXIS], mesh.data_group)
            terms.append((f"{spec.name}:{name}", E._partial_pair_loss(iii, embed, weight, banks.n)))
    return terms, iii


def _placed_terms(cfg: StepConfig, rendered: list[_Banks], inputs: dict, want_embeds: bool):
    """Every tower's terms under ensemble placement, through
    ``ensemble.ensemble_scores``: member ``p`` scored on model group
    ``p % M``, each rank's part left unsummed (the step sums it with the
    gradient), in the sequential path's term order.  The image prompts are
    pair jobs; ``want_embeds``: the last tower's whole main batch encoded
    once, for the custom losses.  → (terms, embeds or None)."""
    specs = cfg.perceptors
    empty = lambda spec: PromptTable(spec.table.embeds[:0], spec.table.weights[:0], spec.table.stops[:0])
    table_or_empty = lambda table, spec: empty(spec) if table is None else table
    mains = [b.main for b in rendered]
    job_batches = {"main": mains, "target": mains,  # the target rows score the main embeddings
                   "spot": [b.main if b.spot is None else b.spot for b in rendered],
                   "spot_off": [b.main if b.spot_off is None else b.spot_off for b in rendered]}
    job_tables = {"main": [s.table for s in specs],
                  "target": [table_or_empty(s.target_table, s) for s in specs],
                  "spot": [table_or_empty(s.spot_table, s) for s in specs],
                  "spot_off": [table_or_empty(s.spot_off_table, s) for s in specs]}
    pair_jobs = {}
    for name in dict.fromkeys(name for b in rendered for name, _bank in b.prompts):
        batches, weights = [], []
        for spec, b in zip(specs, rendered):
            bank = dict(b.prompts).get(name)
            batches.append(b.main if bank is None else bank)  # weight 0: not scored
            weights.append(0.0 if bank is None else 1.0 if spec.image_prompt_weight is None
                           else spec.image_prompt_weight)
        pair_jobs[name] = (batches, weights)
    members = [E.EnsembleMember(s.name, lambda _v, rows, affine=None, f=s.image_fn: f(rows, affine=affine),
                                int(s.table.embeds.shape[1]), s.affine_fn) for s in specs]
    vals, embeds = E.ensemble_scores(cfg.mesh, members, job_batches, job_tables, [None] * len(specs),
                                     want_iii_of=len(specs) - 1 if want_embeds else None, pair_jobs=pair_jobs,
                                     reduce=False)
    terms = []
    for p, (spec, b) in enumerate(zip(specs, rendered)):
        terms += [(f"{spec.name}:prompt{i}", vals["main"][p, i]) for i in range(spec.table.size)]
        if spec.target_table is not None and spec.target_table.size:
            terms.append((f"{spec.name}:target_frame",
                          vals["target"][p].index_select(0, _target_frame(spec.target_table, inputs))[0]))
        for kind, table in (("spot", spec.spot_table), ("spot_off", spec.spot_off_table)):
            terms += [(f"{spec.name}:{kind}{i}", vals[kind][p, i]) for i in range(0 if table is None else table.size)]
        for name, _bank in b.prompts:  # a weight of 0 everywhere leaves the kind out: its term is 0
            terms.append((f"{spec.name}:{name}", vals[name][p, 0] if name in vals else b.main.new_zeros(())))
    return terms, embeds


def _encode(cfg: StepConfig, spec: PerceptorSpec, bank):
    """A bank's embeddings: all its rows, or under a mesh the rank's data
    chunk, stretched by the whole bank's range (``adjust_range`` takes the
    bank's min and max)."""
    if cfg.mesh is None:
        return P.ranged(f"tower.{spec.name}", spec.image_fn, bank)
    return P.ranged(f"tower.{spec.name}", spec.image_fn, M.shard_cutout_batch(bank, cfg.mesh),
                    affine=spec.affine_fn(bank))


def inputs_loss_and_grads(cfg: StepConfig, z, inputs: list[dict]):
    """Gradients of the loss w.r.t. each leaf of ``z``, summed over the
    batches (one entry of ``inputs`` each), and the first batch's (total,
    values, img)."""
    params = [p.detach().requires_grad_(True) for p in leaves(z)]
    zp = unflatten(z, params)
    grads = None
    first = None
    for batch in inputs:
        with contextlib.ExitStack() as gathered:  # FSDP: the towers' weights whole for this batch
            for weights in cfg.fsdp:
                gathered.enter_context(weights.gathered())
            total, (vals, img) = loss_fn(cfg, zp, batch)
            # a rank whose loss reaches no leaf (a model group without a member) has zero gradients
            gs = (torch.autograd.grad(total, params, allow_unused=True) if total.requires_grad
                  else [None] * len(params))
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        grads = gs if grads is None else [a + b for a, b in zip(grads, gs)]
        if first is None:
            first = (total.detach(), vals.detach(), img.detach())
    if cfg.mesh is not None:
        grads, first = _reduce_over_mesh(cfg, grads, first)
    return unflatten(z, grads), first


def _reduce_over_mesh(cfg: StepConfig, grads, first):
    """One sum of the gradients and the first batch's values over the mesh,
    so every rank steps on the same bits.  Under FSDP the model groups
    compute the same chunks: only the ranks of model index 0 add theirs
    (the others add zeros), as the copies differ in their last bits where
    K2 sums with float atomics."""
    mesh = cfg.mesh
    _total, vals, img = first
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [vals.float()])
    if cfg.fsdp and mesh.model_index != 0:
        flat.zero_()
    M.all_reduce_(flat, mesh.group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
        off += g.numel()
    vals = flat[off:].to(vals.dtype)
    return out, (vals.sum(), vals, img)


def loss_and_grads(cfg: StepConfig, z, iteration: int, batch_draws: list[dict]):
    """:func:`inputs_loss_and_grads` of a step's draws (one dict per batch)."""
    device = leaves(z)[0].device
    return inputs_loss_and_grads(cfg, z, draws_to_inputs(cfg, batch_draws, iteration, device))


def train_step(cfg: StepConfig, optimizer, z, opt_state, lr_scale, inputs: list[dict]):
    """One optimizer step, written into ``z`` and ``opt_state``.  ``inputs``
    holds one entry per batch (:func:`step_inputs`); gradients sum over the
    batches, metrics come from the first.  The LR scale (a () tensor on the
    step's device) multiplies every group's update alike.

    Returns (total, values, img)."""
    grads, first = inputs_loss_and_grads(cfg, z, inputs)
    with torch.no_grad():
        updates, _ = optimizer.update(grads, opt_state, z)
        new = cfg.drawer.clip_params(tree_map(lambda p, u: p.detach() + u * lr_scale, z, updates))
        for dst, src in zip(leaves(z), leaves(new)):
            dst.copy_(src)
    return first


class BlockResult:
    """The losses of a block: totals (n,) and values (n, L), on the host
    once ``done`` (a CUDA event, or None) has passed.  ``record``: the
    dispatch's :class:`~pixray_tpu_torch.engine.profiling.BlockRecord`,
    which gets the wait and (``ranges``: the replayed graph's
    :class:`~pixray_tpu_torch.engine.profiling.LayerRanges`, or None) the
    device ms of each layer range, unless a later replay read them first."""

    def __init__(self, totals, values, record, done=None, ranges=None):
        self.totals, self.values, self.record, self.done, self.ranges = totals, values, record, done, ranges

    def host(self):
        with P.span("block.loss_wait") as wait:
            if self.done is not None:
                self.done.synchronize()
        self.record.loss_wait_s = wait.seconds
        if self.ranges is not None:
            self.ranges.read(self.record)
        return self.totals.clone(), self.values.clone()


class StepBlock:
    """``n`` optimizer steps from inputs at fixed addresses (the counterpart
    of the JAX package's ``build_multi_step``).

    The host draws each step in the eager order, packs its inputs (the
    parameter rows and the int32 tail of the iteration and the filter
    shifts, :func:`pack_step`) into one of two page-locked staging buffers
    and draws its noise planes straight into the block's planes
    (:meth:`plane_targets`); :meth:`upload` copies the staging buffer into
    the block's inputs with one stream-ordered copy.  A staging buffer is
    written again only after its copy has run.

    On CUDA, :meth:`run` captures the ``n`` whole steps (forward, backward,
    Adam, LR scale, clamp) into one CUDA graph at its first call, after one
    warm-up step on a side stream that writes copies of the latent and the
    optimizer state, and then each block is one replay, which writes the
    latent and the state in place.  Garbage collection is held off during
    the capture (collecting an unreachable engine would destroy its graph
    inside it).  A capture that fails raises.  The launch
    counters move by what the capture recorded at each replay (the capture
    itself launches nothing).  Under a mesh over NCCL the graph holds every
    collective of its steps, and every rank captures and replays them in
    one order, as every rank dispatches the same blocks.  On the CPU a
    block is ``n`` eager steps from the same inputs.

    A block captured while the layer ranges are on (``profiling.time_layers``)
    holds their events; each replay first reads the last one's, waiting for
    it where its losses have not reached the host.  Each call's span seconds go
    into ``record``, which ``Engine._dispatch_block`` sets anew for each
    dispatch."""

    def __init__(self, cfg: StepConfig, optimizer, n: int, cut_counts: list[int], device, skip=frozenset()):
        self.cfg, self.optimizer, self.n, self.cut_counts = cfg, optimizer, n, cut_counts
        self.skip = frozenset(skip)  # custom losses whose gate is off at every step of the blocks it runs
        self.device = torch.device(device)
        on_cuda = self.device.type == "cuda"
        shape = (n, sum(input_sizes(cfg, cut_counts)))
        self.staging = [torch.zeros(shape, dtype=torch.float32, pin_memory=on_cuda) for _ in range(2)]
        self.copied = [None, None]  # the event after each staging buffer's copy
        self.turn = 0
        self.buf = torch.zeros(shape, dtype=torch.float32, device=self.device)
        dtype = cfg.compute_dtype or torch.float32
        self.planes = [torch.zeros((n, cfg.batches, 3, c, spec.cut_size, spec.cut_size), dtype=dtype,
                                   device=self.device)
                       for c, spec in zip(cut_counts, cfg.perceptors)]
        self.graph = None
        self.ranges = None  # the graph's LayerRanges, when captured with the layer ranges on
        self.addresses = None
        self.launches = None
        self.capture_s = None
        self.totals = self.values = None
        self.record = P.BlockRecord(None, None, n)

    def plane_targets(self, s: int):
        """Per batch, per perceptor: the three planes step ``s`` draws into."""
        return [[tuple(p[s, b].unbind(0)) for p in self.planes] for b in range(self.cfg.batches)]

    def inputs(self, s: int):
        return step_inputs(self.cfg, self.buf[s], self.plane_targets(s), self.cut_counts, self.skip)

    def staging_inputs(self):
        """The next staging buffer, free to write, as (rows (n, batches, R,
        PARAM_STRIDE), int32 tails (n, T)) views."""
        self.turn ^= 1
        with P.span("block.stage_wait") as wait:
            if self.copied[self.turn] is not None:
                self.copied[self.turn].synchronize()
        self.record.stage_wait_s = wait.seconds
        return split_inputs(self.cfg, self.staging[self.turn], self.cut_counts)

    def upload(self):
        """Copy the staging buffer last handed out into the block's inputs."""
        with P.span("block.upload") as upload:
            self.buf.copy_(self.staging[self.turn], non_blocking=True)
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                self.copied[self.turn] = event
        self.record.upload_s = upload.seconds

    def run(self, z, opt_state, lr_scale) -> BlockResult:
        """The block's ``n`` steps from the uploaded inputs, in place on ``z``
        and ``opt_state``; the losses come back in a :class:`BlockResult`."""
        if self.device.type != "cuda":
            with P.span("block.launch") as launch:
                out = [train_step(self.cfg, self.optimizer, z, opt_state, lr_scale, self.inputs(s))
                       for s in range(self.n)]
            self.record.launch_s = launch.seconds
            return BlockResult(torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]), self.record)
        live = [t.data_ptr() for t in leaves(z) + state_tensors(opt_state) + [lr_scale]]
        if self.graph is None:
            with P.span("block.capture") as capture:
                self._capture(z, opt_state, lr_scale)
            self.capture_s = self.record.capture_s = capture.seconds
            self.addresses = live
        elif live != self.addresses:
            raise RuntimeError("the latent, the optimizer state or the LR scale is not the one the "
                               "block's CUDA graph was captured on")
        with P.span("block.launch") as launch:
            if self.ranges is not None:
                self.ranges.read()  # the last replay's events, before this one records them again
            self.graph.replay()
            for counter, recorded in zip(LAUNCH_COUNTERS, self.launches):
                for name, count in recorded.items():
                    counter[name] += count
            totals = torch.empty(self.totals.shape, dtype=self.totals.dtype, pin_memory=True)
            values = torch.empty(self.values.shape, dtype=self.values.dtype, pin_memory=True)
            totals.copy_(self.totals, non_blocking=True)
            values.copy_(self.values, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self.record.launch_s = launch.seconds
        if self.ranges is not None:
            self.ranges.replayed(self.record, done)
        return BlockResult(totals, values, self.record, done, self.ranges)

    def _capture(self, z, opt_state, lr_scale):
        cfg, opt = self.cfg, self.optimizer
        main = torch.cuda.current_stream(self.device)
        side = _WARMUP_STREAMS.get(self.device)
        if side is None:
            side = _WARMUP_STREAMS[self.device] = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # first use on this stream (cuBLAS workspaces, cuDNN's choice, the
            # kernels' attributes), on copies: the run does not advance.  Under
            # a mesh it runs the step's collectives, which makes each group's
            # NCCL communicator (made at its first collective, which a capture
            # may not do).  PyTorch 2.11 with NCCL 2.28 needs nothing more:
            # ProcessGroupNCCL leaves captured work out of its watchdog, so its
            # async error handling stays on, and the collective's fork to
            # NCCL's stream and join back hold under a thread-local capture
            total, values, _ = train_step(cfg, opt, tree_map(torch.clone, z), opt.clone(opt_state),
                                          lr_scale, self.inputs(0))
        main.wait_stream(side)
        self.totals = torch.zeros((self.n,), dtype=total.dtype, device=self.device)
        self.values = torch.zeros((self.n, values.numel()), dtype=values.dtype, device=self.device)
        ranges = P.LayerRanges() if P.layers_on() else None
        # the graph is kept beside its executable, so that debug_dump can
        # print it (chip_smoke.py counts the collectives of a block from it)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # no garbage collection inside the capture: collecting an unreachable
        # engine destroys its graph, a call the capture may not see.  One
        # capture at a time in the process (the collector's switch is global);
        # the thread-local mode lets another thread's engine (a server's
        # abandoned job) synchronize and allocate meanwhile, where the global
        # mode would fail either the capture or that thread's call
        with _CAPTURE_LOCK:
            before = [dict(counter) for counter in LAUNCH_COUNTERS]
            gc.collect()
            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                with P.recording(ranges), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    for s in range(self.n):
                        total, values, _ = train_step(cfg, opt, z, opt_state, lr_scale, self.inputs(s))
                        self.totals[s].copy_(total)
                        self.values[s].copy_(values)
            except Exception as exc:
                raise RuntimeError(f"capturing the {self.n}-step block into a CUDA graph failed: {exc}") from exc
            finally:
                if gc_was_enabled:
                    gc.enable()
                self.launches = [{k: counter[k] - b[k] for k in counter}
                                 for counter, b in zip(LAUNCH_COUNTERS, before)]
                for counter, b in zip(LAUNCH_COUNTERS, before):
                    counter.update(b)  # recorded into the graph, not launched
        graph.instantiate()
        self.graph = graph
        self.ranges = None if ranges is None else ranges.finish()
