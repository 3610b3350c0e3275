"""The device mesh on ``torch.distributed`` (port of ``pixray_tpu/parallel/mesh.py``).

One process per device ("rank").  A mesh of shape (data=D, model=M) puts
rank ``r`` at data index ``r // M`` and model index ``r % M`` (the JAX
package's row-major device grid), so hosts fill the outer (data) axis:

- **data**: each step's cutout bank is split into D contiguous chunks of
  rows; a rank encodes its chunk, and the latent's gradient is summed over
  the ranks with one ``all_reduce`` per step (``engine/step.py``).
- **model**: perceptor-ensemble placement (``parallel/ensemble.py``: member
  ``p`` on model index ``p % M``), or, with one perceptor, FSDP: each 2-D+
  weight of the vision tower keeps only its shard (:func:`shard_perceptor_params`;
  the text tower and the int8 rungs' pre-quantized weights stay whole),
  and the model groups compute the same chunks.
- **hosts**: ``--mesh_shape hosts`` is (hosts, ranks per host).

Meshes come from the ``--mesh_shape`` setting with the JAX grammar:
'auto' = every rank on the data axis, 'D' or 'D,M' = explicit sizes,
'hosts' = (hosts, local ranks).  A shape larger than the world raises
``ValueError``; a world (or shape) of one rank gives no mesh.  Every rank
creates every subgroup, in one fixed order: ``new_group`` is collective,
and a rank that creates only its own groups hangs the others.

Collectives: sums (``all_reduce``) and ``broadcast`` only, because gloo
has no ``all_gather`` for CUDA tensors and several ranks that share one
card must use gloo (NCCL refuses two ranks on one device).  The one gather
(:func:`gather_along`, :class:`GatherRows`) is a sum of zero-filled full
buffers, each holding its rank's rows: exact, as the fill is -0.0 (x + -0.0
is x for every x, -0.0 included).  Over NCCL the collectives run on the
card, so a step's sit in its block's CUDA graph (:func:`step_capturable`);
gloo's run on the host, and a card's step over gloo is eager.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# (local rank, ranks on this host) of the process, set by init_distributed
_LOCAL: dict = {}
LOOPBACK = ("localhost", "127.0.0.1", "::1", "[::1]")
DIST_TIMEOUT_S = 600.0  # the process group's collectives' deadline, unless timeout_s gives one


def _env_int(name):
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     timeout_s: float = DIST_TIMEOUT_S, device=None) -> bool:
    """Join a process group (a no-op returning False when none is configured).

    Arguments fall back to ``$PIXRAY_TPU_COORDINATOR`` (host:port) /
    ``$PIXRAY_TPU_NUM_PROCESSES`` / ``$PIXRAY_TPU_PROCESS_ID``, then to
    torchrun's ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
    Ranks per host are ``$LOCAL_WORLD_SIZE`` (torchrun's), else every rank
    when the coordinator is a loopback address, else one; the local rank is
    ``$LOCAL_RANK``, else the rank modulo that.  The backend, unless
    given, is ``gloo`` for a CPU ``device`` (the engine's); otherwise
    ``nccl`` when each local rank has a card of its own, else ``gloo``
    (several ranks on one card, or no card).  ``timeout_s`` bounds each
    collective.
    Idempotent: an initialized group is kept.  Returns True when the group
    has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("PIXRAY_TPU_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _env_int("PIXRAY_TPU_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("PIXRAY_TPU_PROCESS_ID")
    if coordinator is None and num_processes is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
            return False  # a single-process run: nothing to join
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    missing = [n for n, v in (("coordinator", coordinator), ("num_processes", num_processes),
                              ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed needs {', '.join(missing)} (PIXRAY_TPU_COORDINATOR, "
                         "PIXRAY_TPU_NUM_PROCESSES, PIXRAY_TPU_PROCESS_ID)")
    host = coordinator.rsplit(":", 1)[0]
    local_world = _env_int("LOCAL_WORLD_SIZE") or (num_processes if host in LOOPBACK else 1)
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id % local_world if local_rank is None else local_rank
    if backend is None and device is not None and torch.device(device).type == "cpu":
        backend = "gloo"  # a CPU tensor has no nccl collective
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local_world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    _LOCAL.update(rank=local_rank, world=local_world)
    return num_processes > 1


def local_rank() -> int:
    """This process's rank on its host (0 outside a process group)."""
    return _LOCAL.get("rank", 0) if dist.is_initialized() else 0


def world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) outside one."""
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def mesh_dims(mesh_shape, n: int, hosts: int = 1) -> tuple[int, int] | None:
    """(D, M) of ``mesh_shape`` over ``n`` ranks on ``hosts`` hosts, as the
    JAX ``build_mesh`` sizes it; None for a mesh of one rank."""
    if mesh_shape in (None, "", "auto"):
        dims = (n, 1)
    elif mesh_shape == "hosts":
        dims = (hosts, n // hosts)
    else:
        parts = [int(p) for p in str(mesh_shape).split(",")]
        dims = (parts[0], parts[1] if len(parts) > 1 else 1)
    if dims[0] * dims[1] > n:
        raise ValueError(f"mesh_shape {dims} needs {dims[0] * dims[1]} devices, have {n}")
    return None if dims[0] * dims[1] <= 1 else dims


@dataclass
class Mesh:
    """One rank's view of a (data, model) mesh: its indices and its groups
    (``group``: the mesh's ranks; ``data_group``: the ranks of its model
    index; ``model_group``: the ranks of its data index)."""

    shape: dict
    rank: int
    data_index: int
    model_index: int
    group: Any
    data_group: Any
    model_group: Any

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]


def build_mesh(mesh_shape="auto") -> Mesh | None:
    """This rank's :class:`Mesh` over the process group; None for a mesh of
    one rank, and for a rank the mesh leaves out (a shape smaller than the
    world takes the first D·M ranks).  Collective: every rank calls it."""
    rank, n = world()
    local = _LOCAL.get("world", n) if dist.is_initialized() else 1
    dims = mesh_dims(mesh_shape, n, max(n // local, 1))
    if dims is None:
        return None
    d, m = dims
    # every rank creates every group, in this order (new_group is collective)
    group = dist.group.WORLD if d * m == n else dist.new_group(list(range(d * m)))
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    if rank >= d * m:
        return None
    return Mesh({DATA_AXIS: d, MODEL_AXIS: m}, rank, rank // m, rank % m, group,
                data_groups[rank % m], model_groups[rank // m])


def one_rank_mesh() -> Mesh:
    """A (1, 1) :class:`Mesh` over the process group of one rank, every
    group the world: the sharded step's code on one device, as the JAX
    package's ``tools/tpu_mesh_smoke.py`` builds a 1-device mesh
    (:func:`build_mesh` gives None for one rank)."""
    if world()[1] != 1 or not dist.is_initialized():
        raise ValueError(f"one_rank_mesh needs a process group of one rank, not {world()[1]}")
    g = dist.group.WORLD
    return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, 0, 0, g, g, g)


def step_capturable(mesh: Mesh) -> bool:
    """Whether a step sharded over ``mesh`` can be captured into a CUDA
    graph: NCCL enqueues its collectives on the card, where a capture
    records them; gloo runs them on the host, outside any graph."""
    return dist.get_backend(mesh.group) == "nccl"


def host_local(x) -> np.ndarray:
    """A tensor's value as a numpy copy (every rank holds whole tensors)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def replicated(tree, mesh: Mesh | None):
    """The tree itself: a rank's tensors are local and every rank computes
    the replicated values from the same seed (the JAX call places them)."""
    return tree


def shard_cutout_batch(batch, mesh: Mesh | None):
    """The rank's rows ``[d·chunk, (d+1)·chunk)`` of an (N, ...) bank."""
    if mesh is None:
        return batch
    chunk = batch.shape[0] // mesh.shape[DATA_AXIS]
    return batch.narrow(0, mesh.data_index * chunk, chunk)


def pad_cuts_for_mesh(num_cuts: int, mesh: Mesh | None) -> int:
    """Round the cutout count up to a multiple of the data-axis size."""
    if mesh is None:
        return num_cuts
    d = mesh.shape[DATA_AXIS]
    return -(-num_cuts // d) * d


def all_reduce_(t, group):
    """Sum ``t`` over ``group`` in place (gloo and NCCL, CPU and CUDA).

    Over NCCL a float tensor's sum is premultiplied by 1.0: the same bits
    (x * 1.0 is x, -0.0 included), but NCCL launches it on a group of one
    rank too, where it drops a plain sum without a kernel; so a captured
    block holds one NCCL kernel per collective on any group size."""
    op = dist.ReduceOp.SUM
    if t.is_floating_point() and dist.get_backend(group) == "nccl":
        op = dist._make_nccl_premul_sum(1.0)
    dist.all_reduce(t, op=op, group=group)
    return t


def gather_along(x, axis: int, index: int, count: int, group):
    """The ``count`` equal pieces of the ranks of ``group`` joined along
    ``axis``, this rank's ``x`` being piece ``index``: a sum of -0.0-filled
    full buffers, exact bit for bit."""
    shape = list(x.shape)
    size = shape[axis]
    shape[axis] = size * count
    full = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
    full.narrow(axis, index * size, size).copy_(x)
    return all_reduce_(full, group)


class GatherRows(torch.autograd.Function):
    """:func:`gather_along` of rows with a gradient: the backward sums the
    cotangent over the group and keeps the rank's rows (``all_gather``'s
    transpose).  Every rank of the group must run the backward."""

    @staticmethod
    def forward(ctx, x, index, count, group):
        ctx.index, ctx.count, ctx.group = index, count, group
        return gather_along(x, 0, index, count, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        size = g.shape[0] // ctx.count
        return g.narrow(0, ctx.index * size, size), None, None, None


class SumOver(torch.autograd.Function):
    """A rank's partial value summed over a group; the backward is the
    identity: each rank back-propagates the (equal) cotangent into its own
    part, and the latent's gradient is then summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_axis(shape, m: int) -> int | None:
    """The FSDP rule: a 2-D+ leaf splits along its largest axis that ``m``
    divides (the first such axis on a tie); None keeps it whole."""
    if len(shape) < 2:
        return None
    for axis in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[axis] % m == 0:
            return axis
    return None


class ShardedWeights:
    """FSDP of a frozen module's weights over the model axis
    (``shard_perceptor_params``): each 2-D+ parameter and buffer keeps only
    the model index's piece along :func:`shard_axis`; :meth:`gathered`
    joins the pieces (one sum over the model group per leaf) for the
    forward and the backward that read them, and frees them after."""

    def __init__(self, module, mesh: Mesh):
        self.m, self.index, self.group = mesh.shape[MODEL_AXIS], mesh.model_index, mesh.model_group
        self.leaves = []  # (tensor, axis, its shard)
        for t in list(module.parameters()) + list(module.buffers()):
            axis = shard_axis(t.shape, self.m)
            if axis is None:
                continue
            size = t.shape[axis] // self.m
            shard = t.data.narrow(axis, self.index * size, size).clone()
            t.data = shard
            self.leaves.append((t, axis, shard))

    @contextmanager
    def gathered(self):
        for t, axis, shard in self.leaves:
            t.data = gather_along(shard, axis, self.index, self.m, self.group)
        try:
            yield
        finally:
            for t, _axis, shard in self.leaves:
                t.data = shard


def shard_perceptor_params(module, mesh: Mesh | None) -> ShardedWeights | None:
    """FSDP over the model axis (None, and the weights kept whole, when the
    axis has one rank or there is no mesh)."""
    if mesh is None or mesh.shape[MODEL_AXIS] <= 1:
        return None
    return ShardedWeights(module, mesh)


def ranks_bitwise_equal(tensors, mesh: Mesh) -> bool:
    """Whether every rank of the mesh holds the bits of its rank 0's tensors
    (a broadcast from the mesh's first rank, compared on each rank)."""
    same = True
    for t in tensors:
        mine = t.detach().contiguous().view(-1).view(torch.uint8)
        ref = mine.clone()
        dist.broadcast(ref, src=0, group=mesh.group)  # the mesh's rank 0 is the world's
        same = same and bool(torch.equal(ref, mine))
    return same
