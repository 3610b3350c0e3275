"""The optimization step (port of ``build_loss_fn``, ``_build_step_core``
and ``build_multi_step`` in ``pixray_tpu/engine/step.py``, for the terms
the ported slices have).

    synth → [flatten alpha] → per perceptor: pool → cutouts → encode →
    prompt losses;  + init-weight and transparency terms
    then grad → Adam → LR scale → drawer clamp.

Random draws of a step come in a ``draws`` dict (see :func:`pack_step`),
so a caller can replay another implementation's draws.  The host packs
them into the step's inputs: per batch, one block of parameter rows for
all the perceptors' banks (``cutouts.pack_cutouts``: the cut geometry,
the padding mode of the step's parity, jitter, noise factor and the fill)
and the noise planes.  The step itself reads only those and device state,
so it runs as one captured CUDA graph: :class:`StepBlock` holds the inputs
of ``n`` steps at fixed addresses and runs the ``n`` steps as one replay
(the counterpart of the JAX package's ``lax.scan`` block).  The latent
``z`` is a tensor or a dict of tensors (``engine/latent.py``); gradients,
the optimizer and ``batches`` accumulation go leaf by leaf, and the step
writes the new latent and optimizer state into the old ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import time

import torch

from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.latent import leaves, ravel, tree_map, unflatten
from pixray_tpu_torch.engine.optimizers import state_tensors
from pixray_tpu_torch.engine.prompts import PromptTable, prompt_losses
from pixray_tpu_torch.ops import cuda_strokes, cuda_warp
from pixray_tpu_torch.ops.cuda_warp import PARAM_STRIDE, unpack_params
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


# the kernels' launch counters, which a replay advances by what its capture recorded
LAUNCH_COUNTERS = (cuda_warp.LAUNCHES, cuda_strokes.LAUNCHES)


def pack_step(cfg: StepConfig, batch_draws: list[dict], iteration: int, out):
    """Pack one step's draws into its host parameter rows ``out`` (batches,
    sum of the banks' cut counts, PARAM_STRIDE): per batch, each
    perceptor's bank in turn, every row carrying the batch's fill.

    batch_draws: one dict per batch, {"fill": float, "perceptors": [per
    perceptor {"transforms", "jitter", "noise"} as ``cutouts.render_cutouts``
    takes them]}.  The zoom cuts pad by reflection on even iterations."""
    if len(batch_draws) != cfg.batches:
        raise ValueError(f"{len(batch_draws)} draws for {cfg.batches} batches")
    for b, draws in enumerate(batch_draws):
        off = 0
        for pd in draws["perceptors"]:
            n = sum(t.shape[0] for t in pd["transforms"])
            facs = None if pd["noise"] is None else pd["noise"][0]
            C.pack_cutouts(pd["transforms"], reflect_padding=iteration % 2 == 0, fill_color=draws["fill"],
                           jitter=pd["jitter"], facs=facs, out=out[b, off:off + n])
            off += n
        if off != out.shape[1]:
            raise ValueError(f"the draws hold {off} cuts, the rows {out.shape[1]}")
    return out


def step_inputs(rows, planes, cut_counts):
    """The step's inputs, per batch {"fill": () tensor, "perceptors": [per
    perceptor {"params": (N, PARAM_STRIDE), "planes": three (N, S, S) or
    None}]}, as views of ``rows`` (batches, R, PARAM_STRIDE) on the step's
    device and of ``planes`` (per batch, per perceptor); ``cut_counts``: N
    per perceptor."""
    out = []
    for b, batch_planes in enumerate(planes):
        off, perceptors = 0, []
        for zs, n in zip(batch_planes, cut_counts):
            perceptors.append({"params": rows[b, off:off + n], "planes": zs})
            off += n
        out.append({"fill": unpack_params(rows[b])["fill"][0], "perceptors": perceptors})
    return out


def draws_to_inputs(cfg: StepConfig, batch_draws: list[dict], iteration: int, device):
    """One eager step's inputs from its draws: rows packed on the host
    (pinned for the card) and copied to ``device``; the draws' own planes."""
    cuts = [sum(t.shape[0] for t in pd["transforms"]) for pd in batch_draws[0]["perceptors"]]
    rows = torch.zeros((cfg.batches, sum(cuts), PARAM_STRIDE), dtype=torch.float32,
                       pin_memory=torch.device(device).type == "cuda")
    pack_step(cfg, batch_draws, iteration, rows)
    planes = [[None if pd["noise"] is None else tuple(pd["noise"][1]) for pd in d["perceptors"]]
              for d in batch_draws]
    return step_inputs(rows.to(device, non_blocking=True), planes, cuts)


def loss_fn(cfg: StepConfig, z, inputs: dict):
    """→ (total, (values (L,), img)) of one batch.  Loss-term names land in
    ``cfg.names``.  inputs: one batch's entry of :func:`step_inputs`."""
    names, values = [], []

    def add(name, value):
        names.append(name)
        values.append(value)

    img = cfg.drawer.synth(cfg.drawer_params, z)
    alpha = None
    if img.shape[-1] == 4:
        colors = img[..., :3]
        if cfg.transparent:
            alpha = img[..., 3:4]
            img = alpha * colors + (1 - alpha) * inputs["fill"]
        else:
            img = colors

    for spec, pd in zip(cfg.perceptors, inputs["perceptors"]):
        work = C.pool_to_work(img, spec.cut_size)
        cutouts = cuda_warp.cutout_bank(work, pd["params"], spec.cut_size, pd["planes"], cfg.compute_dtype)
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


def inputs_loss_and_grads(cfg: StepConfig, z, inputs: list[dict]):
    """Gradients of the loss w.r.t. each leaf of ``z``, summed over the
    batches (one entry of ``inputs`` each), and the first batch's (total,
    values, img)."""
    params = [p.detach().requires_grad_(True) for p in leaves(z)]
    zp = unflatten(z, params)
    grads = None
    first = None
    for batch in inputs:
        total, (vals, img) = loss_fn(cfg, zp, batch)
        gs = torch.autograd.grad(total, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        grads = gs if grads is None else [a + b for a, b in zip(grads, gs)]
        if first is None:
            first = (total.detach(), vals.detach(), img.detach())
    return unflatten(z, grads), first


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
        updates, _ = optimizer.update(grads, opt_state)
        new = cfg.drawer.clip_params(tree_map(lambda p, u: p.detach() + u * lr_scale, z, updates))
        for dst, src in zip(leaves(z), leaves(new)):
            dst.copy_(src)
    return first


class BlockResult:
    """The losses of a block: totals (n,) and values (n, L), on the host
    once ``done`` (a CUDA event, or None) has passed."""

    def __init__(self, totals, values, done=None):
        self.totals, self.values, self.done = totals, values, done

    def host(self):
        if self.done is not None:
            self.done.synchronize()
        return self.totals.clone(), self.values.clone()


class StepBlock:
    """``n`` optimizer steps from inputs at fixed addresses (the counterpart
    of the JAX package's ``build_multi_step``).

    The host draws each step in the eager order, packs its parameter rows
    into one of two page-locked staging buffers and draws its noise planes
    straight into the block's planes (:meth:`plane_targets`); :meth:`upload`
    copies the staging buffer into the block's rows with one stream-ordered
    copy.  A staging buffer is written again only after its copy has run.

    On CUDA, :meth:`run` captures the ``n`` whole steps (forward, backward,
    Adam, LR scale, clamp) into one CUDA graph at its first call, after one
    warm-up step on a side stream that writes copies of the latent and the
    optimizer state, and then each block is one replay, which writes the
    latent and the state in place.  A capture that fails raises.  The launch
    counters move by what the capture recorded at each replay (the capture
    itself launches nothing).  On the CPU a block is ``n`` eager steps from
    the same inputs."""

    def __init__(self, cfg: StepConfig, optimizer, n: int, cut_counts: list[int], device):
        self.cfg, self.optimizer, self.n, self.cut_counts = cfg, optimizer, n, cut_counts
        self.device = torch.device(device)
        on_cuda = self.device.type == "cuda"
        rows = (n, cfg.batches, sum(cut_counts), PARAM_STRIDE)
        self.staging = [torch.zeros(rows, dtype=torch.float32, pin_memory=on_cuda) for _ in range(2)]
        self.copied = [None, None]  # the event after each staging buffer's copy
        self.turn = 0
        self.rows = torch.zeros(rows, dtype=torch.float32, device=self.device)
        dtype = cfg.compute_dtype or torch.float32
        self.planes = [torch.zeros((n, cfg.batches, 3, c, spec.cut_size, spec.cut_size), dtype=dtype,
                                   device=self.device)
                       for c, spec in zip(cut_counts, cfg.perceptors)]
        self.graph = None
        self.addresses = None
        self.launches = None
        self.capture_s = None
        self.totals = self.values = None

    def plane_targets(self, s: int):
        """Per batch, per perceptor: the three planes step ``s`` draws into."""
        return [[tuple(p[s, b].unbind(0)) for p in self.planes] for b in range(self.cfg.batches)]

    def inputs(self, s: int):
        return step_inputs(self.rows[s], self.plane_targets(s), self.cut_counts)

    def staging_rows(self):
        """The next staging buffer (n, batches, R, PARAM_STRIDE), free to write."""
        self.turn ^= 1
        if self.copied[self.turn] is not None:
            self.copied[self.turn].synchronize()
        return self.staging[self.turn]

    def upload(self, host):
        self.rows.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.copied[self.turn] = event

    def run(self, z, opt_state, lr_scale) -> BlockResult:
        """The block's ``n`` steps from the uploaded inputs, in place on ``z``
        and ``opt_state``; the losses come back in a :class:`BlockResult`."""
        if self.device.type != "cuda":
            out = [train_step(self.cfg, self.optimizer, z, opt_state, lr_scale, self.inputs(s))
                   for s in range(self.n)]
            return BlockResult(torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]))
        live = [t.data_ptr() for t in leaves(z) + state_tensors(opt_state) + [lr_scale]]
        if self.graph is None:
            self._capture(z, opt_state, lr_scale)
            self.addresses = live
        elif live != self.addresses:
            raise RuntimeError("the latent, the optimizer state or the LR scale is not the one the "
                               "block's CUDA graph was captured on")
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
        return BlockResult(totals, values, done)

    def _capture(self, z, opt_state, lr_scale):
        t0 = time.perf_counter()
        cfg, opt = self.cfg, self.optimizer
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # first use on this stream (cuBLAS workspaces, cuDNN's choice, the
            # kernels' attributes), on copies: the run does not advance
            total, values, _ = train_step(cfg, opt, tree_map(torch.clone, z), opt.clone(opt_state),
                                          lr_scale, self.inputs(0))
        main.wait_stream(side)
        self.totals = torch.zeros((self.n,), dtype=total.dtype, device=self.device)
        self.values = torch.zeros((self.n, values.numel()), dtype=values.dtype, device=self.device)
        before = [dict(counter) for counter in LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for s in range(self.n):
                    total, values, _ = train_step(cfg, opt, z, opt_state, lr_scale, self.inputs(s))
                    self.totals[s].copy_(total)
                    self.values[s].copy_(values)
        except Exception as exc:
            raise RuntimeError(f"capturing the {self.n}-step block into a CUDA graph failed: {exc}") from exc
        finally:
            self.launches = [{k: counter[k] - b[k] for k in counter}
                             for counter, b in zip(LAUNCH_COUNTERS, before)]
            for counter, b in zip(LAUNCH_COUNTERS, before):
                counter.update(b)  # recorded into the graph, not launched
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
