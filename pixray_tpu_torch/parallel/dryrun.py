"""Sharded training steps over a mesh of ranks, for dry runs and parity
(port of ``pixray_tpu/parallel/dryrun.py``).

    python -m pixray_tpu_torch.parallel.dryrun N [--device cpu|cuda] [--deadline S]

spawns N ranks (``torch.multiprocessing``'s spawn context, each joined
through :func:`mesh.init_distributed`; gloo when ranks share a card or run
on the CPU) and sweeps the meshes (N, 1), (N/2, 2) and (N/4, 4) as
``__graft_entry__.dryrun_multichip`` does, then FSDP (one tower) on (N/2,
2), printing one line per shape with the loss and latent deltas.

``run_parity`` runs the same seeded trajectory sharded over a mesh and
unsharded on the same rank, and asserts that the losses and the final
latent agree: sharding is a placement decision, not a change of numerics.
Every rank also holds its latent bitwise against rank 0's.

:func:`launch` is the spawner the tests and ``chip_smoke.py`` use: every
rank gets a deadline, a rank that raises, hangs past it or exits non-zero
fails the launch, and every rank still alive at the end is killed.
"""

from __future__ import annotations

import argparse
import copy
import gc
import os
import queue
import re
import socket
import tempfile
import time
import traceback

import numpy as np


def tiny_settings(**overrides):
    """Flagship-shaped settings at dry-run scale (no side effects, no assets);
    f32 towers, as the JAX dry run builds them."""
    from pixray_tpu_torch.config import apply_settings

    kw = dict(drawer="pixel", prompts="a sunrise", clip_models="TinyTest", size=[64, 36], iterations=4,
              save_every=1000, init_noise=None, vector_prompts="none", num_cuts=8, batches=1, seed=7, outdir="",
              save_intermediates=False, learning_rate_drops=[], shard_cutouts=False, precision="fp32",
              steps_per_call=1)
    kw.update(overrides)
    return apply_settings(kw, apply_side_effects=False)


# per-process memo of the unsharded trajectories (a sweep reuses each baseline)
_baseline_memo: dict = {}


def trajectory(settings, n_steps: int, device="cuda", mesh=None, steps_per_call: int = 1) -> dict:
    """``n_steps`` steps of an Engine on ``settings`` (sharded when ``mesh``
    or the settings give one), dispatched as ``--steps_per_call``
    ``steps_per_call`` gives (1: eager steps; a block's steps all run, on
    the card as one graph replay, at the call for its first step), with the
    launch counters at 0 just before them.  Returns :func:`drive`'s dict
    and "engine"."""
    from pixray_tpu_torch.engine.core import Engine

    with tempfile.TemporaryDirectory() as outdir:
        settings.outdir, settings.steps_per_call = outdir, steps_per_call
        engine = Engine(settings, device=device, mesh=mesh)
        return dict(drive(engine, n_steps), engine=engine)


def _flat(tree) -> np.ndarray:
    import torch

    from pixray_tpu_torch.engine.latent import leaves

    return torch.cat([t.detach().float().reshape(-1) for t in leaves(tree)]).cpu().numpy()


def drive(engine, n_steps: int) -> dict:
    """Steps 0 to ``n_steps`` - 1 of ``engine``, the launch counters at 0
    just before them.  Returns {"losses" (per step, the sum of its values),
    "values" (per step, numpy), "z0" and "z" (numpy, before and after),
    "bitwise" (under a mesh: after every step the latent on every rank
    equal to rank 0's), "launches" (per step, the K1 and K2 counts), "ms"
    (per step, to a synchronize on the card), "peak_mib" (CUDA)}."""
    import torch

    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.parallel.mesh import ranks_bitwise_equal

    z0 = _flat(engine.z)
    on_cuda = engine.device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    cuda_warp.reset_launch_counts()
    losses, values, launches, ms, bitwise = [], [], [], [], True
    for it in range(n_steps):
        before = dict(cuda_warp.LAUNCHES)
        t0 = time.perf_counter()
        engine.train(it)
        vals = engine.last_loss_values.float()
        losses.append(float(vals.sum()))
        values.append(vals.cpu().numpy())
        if on_cuda:
            torch.cuda.synchronize(engine.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: v - before[k] for k, v in cuda_warp.LAUNCHES.items() if v != before[k]})
        if engine.mesh is not None:
            bitwise = ranks_bitwise_equal(leaves(engine.z), engine.mesh) and bitwise
    return {"losses": losses, "values": values, "z0": z0, "z": _flat(engine.z),
            "bitwise": bitwise, "launches": launches, "ms": ms,
            "peak_mib": torch.cuda.max_memory_allocated(engine.device) / 2**20 if on_cuda else None}


def run_config(config: dict, n_steps: int, device="cuda", mesh_shape: str | None = None,
               steps_per_call: int = 1) -> dict:
    """:func:`trajectory` of a settings dict (the bench rows'), sharded over
    the process group on ``mesh_shape`` or unsharded (None), without the
    engine: what a spawned rank sends back."""
    from pixray_tpu_torch.config import apply_settings

    settings = apply_settings(dict(config, shard_cutouts=mesh_shape is not None, mesh_shape=mesh_shape or "auto",
                                   iterations=n_steps), apply_side_effects=False)
    out = trajectory(settings, n_steps, device, steps_per_call=steps_per_call)
    engine = out.pop("engine")
    out.update(mesh=None if engine.mesh is None else engine.mesh.shape, names=list(engine.loss_names))
    return out


def all_reduce_check(numel: int) -> dict:
    """One sum over the process group of a ``numel`` float32 buffer on this
    rank's card (a latent gradient's size): the backend, whether a 1-rank
    sum kept the bits, and its ms."""
    import torch
    import torch.distributed as dist

    from pixray_tpu_torch.parallel.mesh import all_reduce_, local_rank

    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    buf = torch.randn(numel, generator=torch.Generator().manual_seed(0)).to(dev)
    want = buf.clone()
    all_reduce_(buf, None)  # warm-up
    buf.copy_(want)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    all_reduce_(buf, None)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(), "numel": numel,
            "exact": dist.get_world_size() == 1 and bool(torch.equal(buf, want)), "ms": ms}


def agreement(sharded: dict, base: dict) -> dict:
    """Two trajectories' gaps: "loss", the largest per-step |Δ loss|; "z",
    the final latents' max |Δ z| / max |z| (the JAX ``run_parity``'s);
    "z_l2", ||Δ z|| / ||z||."""
    dz = sharded["z"] - base["z"]
    return {"loss": float(np.max(np.abs(np.asarray(sharded["losses"]) - np.asarray(base["losses"])))),
            "z": float(np.max(np.abs(dz))) / (float(np.max(np.abs(base["z"]))) or 1.0),
            "z_l2": float(np.linalg.norm(dz)) / (float(np.linalg.norm(base["z"])) or 1.0)}


def _names(mesh) -> list[str]:
    from pixray_tpu_torch.parallel.mesh import MODEL_AXIS

    # a model axis of 2 or more: 3 members (on 2 groups, uneven placement)
    return ["TinyTest", "TinyTest48", "TinyTestDim48"] if mesh.shape[MODEL_AXIS] >= 2 else ["TinyTest"]


def run_sharded_step(mesh, num_cuts: int | None = None, device="cuda") -> float:
    """ONE full training step sharded over ``mesh`` (two towers placed on
    a model axis > 1, one tower data-parallel otherwise): returns the
    finite loss; raises if it is not finite, the latent did not move or
    the ranks' latents differ."""
    from pixray_tpu_torch.parallel.mesh import MODEL_AXIS

    names = ["TinyTest"] + (["TinyTest48"] if mesh.shape[MODEL_AXIS] > 1 else [])
    run = trajectory(tiny_settings(clip_models=",".join(names), num_cuts=num_cuts or 2 * mesh.size), 1, device, mesh)
    total = run["losses"][0]
    assert np.isfinite(total), "sharded step produced a non-finite loss"
    assert not np.allclose(run["z"], run["z0"]), "sharded step did not update the latent"
    assert run["bitwise"], "ranks hold different latents after the sharded step"
    return total


def run_parity(mesh, n_steps: int = 3, num_cuts: int | None = None, loss_tol: float = 2e-3, z_tol: float = 2e-3,
               names: list[str] | None = None, device="cuda", steps_per_call: int = 1) -> dict:
    """Sharded-vs-unsharded trajectory parity on ``mesh`` (the JAX
    ``run_parity``): the same seeded ``n_steps`` run sharded and then
    unsharded on this rank, both dispatched as ``steps_per_call`` gives;
    per-step losses within ``loss_tol``, the final latent within ``z_tol``
    of its largest value, every rank's latent bitwise rank 0's after every
    step.  Under FSDP the gathered tower weights must be the unsharded ones
    bit for bit.

    Returns {'shape', 'ensemble', 'fsdp', 'members', 'loss_delta', 'z_delta', 'loss0', 'blocks' (the sharded
    run's dispatched blocks)}."""
    import torch

    from pixray_tpu_torch.parallel.ensemble import ensemble_active

    names = names or _names(mesh)
    n_cuts = num_cuts or 2 * mesh.size
    settings = lambda: tiny_settings(clip_models=",".join(names), num_cuts=n_cuts, iterations=n_steps)
    sharded = trajectory(settings(), n_steps, device, mesh, steps_per_call)
    key = (tuple(names), n_cuts, n_steps, str(device), steps_per_call)
    if key not in _baseline_memo:
        base = trajectory(settings(), n_steps, device, steps_per_call=steps_per_call)
        _baseline_memo[key] = dict(base, engine=None,
                                   weights=[{k: v.clone() for k, v in p.model.visual.state_dict().items()}
                                            for p in base["engine"].perceptors])
    base = _baseline_memo[key]
    gap = agreement(sharded, base)
    loss_delta, z_delta = gap["loss"], gap["z"]
    assert np.all(np.isfinite(sharded["losses"])), "sharded trajectory non-finite"
    assert sharded["bitwise"], f"the ranks' latents differ on mesh {mesh.shape}"
    assert loss_delta <= loss_tol, (f"sharded-vs-unsharded loss trajectories diverge: max |Δ|={loss_delta:.2e} "
                                    f"(tol {loss_tol}) on mesh {mesh.shape}")
    assert z_delta <= z_tol, (f"sharded-vs-unsharded final latents diverge: rel max |Δ|={z_delta:.2e} "
                              f"(tol {z_tol}) on mesh {mesh.shape}")
    engine = sharded["engine"]
    for weights, p, want in zip(engine.step_cfg.fsdp, engine.perceptors, base["weights"]):
        with weights.gathered():
            got = p.model.visual.state_dict()
            assert all(torch.equal(got[k].view(-1).view(torch.uint8), want[k].view(-1).view(torch.uint8))
                       for k in want), "FSDP's gathered weights differ from the unsharded ones"
    return {"shape": dict(mesh.shape), "ensemble": ensemble_active(mesh, len(names)),
            "fsdp": len(engine.step_cfg.fsdp), "members": len(names), "loss_delta": loss_delta, "z_delta": z_delta,
            "loss0": sharded["losses"][0], "blocks": list(engine.dispatched_blocks)}


MESH_SMOKE_STEPS, MESH_SMOKE_BLOCK = 9, 4  # mesh_smoke's blocked parity: an eager step, then 2 blocks of 4
MESH_SMOKE_CUTS = 16  # as the JAX tools/tpu_mesh_smoke.py


def mesh_smoke(device="cuda") -> dict:
    """The sharded step's code on one device (the counterpart of the JAX
    package's ``tools/tpu_mesh_smoke.py``): on :func:`mesh.one_rank_mesh`,
    :func:`run_sharded_step`, then :func:`run_parity` eager and blocked
    (``MESH_SMOKE_STEPS`` steps, blocks of ``MESH_SMOKE_BLOCK`` after the
    first: on the card each block one replay of a CUDA graph that holds its
    steps' collectives).  Run it on a process group of one rank:
    ``launch(mesh_smoke, 1, device, backend=...)``.  Returns {"loss",
    "eager", "blocked" (run_parity's reports), "backend"}."""
    import torch.distributed as dist

    from pixray_tpu_torch.parallel.mesh import one_rank_mesh

    mesh = one_rank_mesh()
    total = run_sharded_step(mesh, MESH_SMOKE_CUTS, device)
    eager = run_parity(mesh, num_cuts=MESH_SMOKE_CUTS, device=device)
    blocked = run_parity(mesh, MESH_SMOKE_STEPS, MESH_SMOKE_CUTS, device=device, steps_per_call=MESH_SMOKE_BLOCK)
    want = [(s, MESH_SMOKE_BLOCK) for s in range(1, MESH_SMOKE_STEPS, MESH_SMOKE_BLOCK)]
    assert blocked["blocks"] == want, f"the blocked sharded run dispatched {blocked['blocks']}, not {want}"
    return {"loss": total, "eager": eager, "blocked": blocked, "backend": dist.get_backend()}


# NCCL's all-reduce kernels by name: a group of one rank's (onerank.cu), then the ring / tree ones
NCCL_ALL_REDUCE = r"oneRankReduce|ncclDevKernel_AllReduce|ncclKernel_AllReduce"


def graph_kernels(graph, path: str) -> tuple[int, int]:
    """(kernel nodes, NCCL all-reduce kernel nodes) of a
    captured block's graph (``StepBlock`` keeps it), read from the graph
    itself: its ``debug_dump`` (``cudaGraphDebugDotPrint``) written to
    ``path``."""
    graph.debug_dump(path)
    with open(path) as f:
        nodes = [n for n in re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)"\];', f.read(), re.S) if "{KERNEL" in n]
    return len(nodes), sum(1 for n in nodes if re.search(NCCL_ALL_REDUCE, n))


def keep_block_starts(engine) -> dict:
    """Wrap ``engine``'s block dispatch: at each block's dispatch keep a copy
    of the latent and the optimizer state (stream-ordered after the work
    before it: the state the block starts from) and the draws of its first
    step.  Returns {first step: {"z", "opt", "draws"}}, filled as it runs."""
    import torch

    from pixray_tpu_torch.engine.latent import tree_map

    kept, dispatch, draw = {}, engine._dispatch_block, engine.draw_step

    def keeping_dispatch(cur_it, n):
        kept[cur_it] = {"z": tree_map(torch.clone, engine.z), "opt": engine.optimizer.clone(engine.opt_state)}
        return dispatch(cur_it, n)

    def keeping_draws(planes_out=None):
        draws = draw(planes_out=planes_out)
        for k in kept.values():
            k.setdefault("draws", copy.deepcopy(draws))
        return draws

    engine._dispatch_block, engine.draw_step = keeping_dispatch, keeping_draws
    return kept


def block_starts_bitwise(engine, kept: dict, values) -> dict:
    """{step: whether the eager step from the state kept at that block's
    dispatch (:func:`keep_block_starts`), with its draws, gives the values
    the block gave for it (``values[step]``) bitwise}.  Writes into the
    kept copies."""
    from pixray_tpu_torch.engine.step import draws_to_inputs, train_step

    out = {}
    for it, k in sorted(kept.items()):
        inputs = draws_to_inputs(engine.step_cfg, k["draws"], it, engine.device, anim_index=engine._anim_index())
        _, vals, _ = train_step(engine.step_cfg, engine.optimizer, k["z"], k["opt"], engine.lr_scale, inputs)
        out[it] = bool(np.array_equal(vals.float().cpu().numpy(), np.asarray(values[it])))
    return out


def _replay_ms(block, reps: int = 3) -> float:
    """Device ms of one replay of ``block``'s graph, CUDA events over ``reps`` (it advances the state)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        block.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sharded_blocks(config: dict, n_steps: int = 17, block: int = 8, dump: str | None = None, device="cuda") -> dict:
    """The blocked sharded step on the card at a bench row's width, on
    :func:`mesh.one_rank_mesh` (one rank, spawned by :func:`launch`): from
    one seed and one set of tower weights, ``n_steps`` steps each of (i)
    eager sharded, (ii) blocked sharded and (iii) blocked unsharded, twice
    ("unsharded", "unsharded2": K2's float atomics part two such runs; step
    0 eager in the blocked runs: its checkin; then blocks of ``block``).
    Each run's "block_z" is the latent each block started from.  Then from (ii):
    the eager sharded step from the state each block started from, with
    its first step's draws ("starts": its values bitwise the replay's);
    at learning-rate scale 0 a blocked and an eager sharded engine from one
    state over one block ("lr0": every step's values bitwise, the latent
    kept bitwise); on the card the kernel nodes of (ii)'s graph and its
    NCCL all-reduce nodes, from ``debug_dump`` to ``dump``.  Returns those,
    and per run :func:`drive`'s dict with "blocks", and on the card
    "capture_s", "replay_ms" (one replay, CUDA events) and "recorded" (the
    launch counts one replay adds).  On the CPU (gloo) it rehearses the
    same steps, each block its steps in a loop."""
    import torch
    import torch.distributed as dist

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.engine.optimizers import state_tensors
    from pixray_tpu_torch.parallel.mesh import one_rank_mesh

    mesh = one_rank_mesh()
    weights = {}
    with tempfile.TemporaryDirectory() as outdir:
        def engine(spc, sharded=True, iterations=n_steps):
            e = Engine(apply_settings(dict(config, shard_cutouts=sharded, steps_per_call=spc, iterations=iterations,
                                           outdir=outdir), apply_side_effects=False),
                       device=device, mesh=mesh if sharded else None, state_dicts=weights or None)
            if not weights:  # the first engine's seeded towers, handed to the others
                weights.update({p.name: {k: v.detach().float().cpu() for k, v in p.model.state_dict().items()}
                                for p in e.perceptors})
            return e

        runs, out = {}, {"backend": dist.get_backend(mesh.group)}
        for name, spc, sharded in (("eager", 1, True), ("blocked", block, True), ("unsharded", block, False),
                                   ("unsharded2", block, False)):
            e = engine(spc, sharded)
            kept = keep_block_starts(e)
            run = drive(e, n_steps)
            run["block_z"] = {it: _flat(k["z"]) for it, k in kept.items()}
            blk = e.step_block
            graph = None if blk is None else blk.graph
            run["blocks"] = list(e.dispatched_blocks)
            if graph is not None:
                run.update(capture_s=blk.capture_s, recorded={k: v for k, v in blk.launches[0].items() if v})
            if name == "blocked":
                out["starts"] = block_starts_bitwise(e, kept, run["values"])
                out["moved"] = not np.array_equal(_flat(kept[min(kept)]["z"]), run["z"])
                if graph is not None and dump is not None:
                    out["kernel_nodes"], out["nccl_nodes"] = graph_kernels(graph, dump)
            if graph is not None:
                run["replay_ms"] = _replay_ms(blk)
            runs[name] = run
            del e, kept, blk, graph
            gc.collect()  # the run's engine and graph go before the next run's peak is taken
        # learning-rate scale 0: one block against its eager steps from one state
        pair = {"blocked": engine(block, iterations=block + 1), "eager": engine(1, iterations=block + 1)}
        for e in pair.values():
            e.train(0)
        with torch.no_grad():
            for dst, src in zip(leaves(pair["eager"].z) + state_tensors(pair["eager"].opt_state),
                                leaves(pair["blocked"].z) + state_tensors(pair["blocked"].opt_state)):
                dst.copy_(src)
            for e in pair.values():
                e.lr_scale.fill_(0.0)
        z0 = _flat(pair["blocked"].z)
        vals = {name: [] for name in pair}
        for name, e in pair.items():
            for it in range(1, block + 1):
                e.train(it)
                vals[name].append(e.last_loss_values.float().cpu().numpy())
        out["lr0"] = {"blocks": list(pair["blocked"].dispatched_blocks),
                      "values_bitwise": [bool(np.array_equal(a, b)) for a, b in zip(vals["blocked"], vals["eager"])],
                      "latent_kept": bool(np.array_equal(_flat(pair["blocked"].z), z0)
                                          and np.array_equal(_flat(pair["eager"].z), z0))}
    out["runs"] = runs
    return out


def sweep_shapes(n: int) -> list[tuple[int, int]]:
    """The mesh shapes ``dryrun_multichip`` sweeps on ``n`` devices."""
    shapes = [(n, 1)]
    if n % 2 == 0 and n >= 4:
        shapes.append((n // 2, 2))
    if n % 4 == 0 and n >= 8:
        shapes.append((n // 4, 4))
    return shapes


def sweep(device="cuda") -> list[dict]:
    """A rank's part of the dry run: :func:`run_parity` on each shape of
    :func:`sweep_shapes` over the whole process group, then FSDP (one
    tower) on (N/2, 2)."""
    from pixray_tpu_torch.parallel.mesh import build_mesh, world

    n = world()[1]
    reports = [run_parity(build_mesh(f"{d},{m}"), device=device) for d, m in sweep_shapes(n)]
    if n % 2 == 0:
        reports.append(run_parity(build_mesh(f"{n // 2},2"), names=["TinyTest"], device=device))
    return reports


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, kwargs, rank, world_size, port, results, env, threads, deadline, backend):
    """One spawned rank: join the group through the PIXRAY_TPU_* variables
    (``backend``, or init_distributed's choice), run ``fn``, report its
    result (or its traceback) to the parent."""
    import torch
    import torch.distributed as dist

    from pixray_tpu_torch.parallel.mesh import init_distributed

    os.environ.update(env, PIXRAY_TPU_COORDINATOR=f"127.0.0.1:{port}", PIXRAY_TPU_NUM_PROCESSES=str(world_size),
                      PIXRAY_TPU_PROCESS_ID=str(rank))
    torch.set_num_threads(threads)
    try:
        init_distributed(backend=backend, timeout_s=deadline)
        out = fn(*args, **kwargs)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, *args, deadline: float = 120.0, env: dict | None = None, threads: int = 1,
           backend: str | None = None, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world_size`` spawned ranks joined in
    one process group (on 127.0.0.1, a port from the OS); returns their
    results in rank order.  ``fn`` must be importable by its module's name.
    Each rank starts with ``OMP_NUM_THREADS`` = ``threads`` and ``env``, and
    joins with ``backend`` (None: ``mesh.init_distributed``'s choice).
    A rank that raises, exits non-zero or outlives ``deadline`` seconds
    raises here; every rank is killed before this returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = []
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(threads)  # read when a rank's torch starts
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_rank_main, args=(fn, args, kwargs, rank, world_size, port, results,
                                                     dict(env or {}), threads, deadline, backend), daemon=True)
            p.start()
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    end = time.monotonic() + deadline
    out = {}
    try:
        while len(out) < world_size:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} of {fn.__name__} "
                                   f"passed the {deadline:.0f} s deadline")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {fn.__name__} exited with "
                                       f"{[procs[r].exitcode for r in dead]} without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{value}")
            out[rank] = value
        for r, p in enumerate(procs):
            p.join(max(end - time.monotonic(), 0.1))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {fn.__name__} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [out[r] for r in range(world_size)]


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ranks", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--deadline", type=float, default=300.0)
    opts = parser.parse_args(argv)
    backend = "gloo" if opts.device == "cpu" else None  # CPU tensors have no nccl collective
    reports = launch(sweep, opts.ranks, deadline=opts.deadline, backend=backend, device=opts.device)[0]
    for rep in reports:
        d, m = rep["shape"]["data"], rep["shape"]["model"]
        kind = (f"[{rep['members']} members placed]" if rep["ensemble"] else
                f"[FSDP, {rep['members']} tower]" if rep["fsdp"] else "")
        print(f"dryrun {d}x{m}{kind} loss={rep['loss0']:.4f} lossΔ={rep['loss_delta']:.1e} "
              f"zΔ={rep['z_delta']:.1e}", flush=True)
    print(f"dryrun OK: {opts.ranks} ranks on {opts.device}, {len(reports)} meshes", flush=True)
    return reports


if __name__ == "__main__":
    main()
