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
import os
import queue
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


def trajectory(settings, n_steps: int, device="cuda", mesh=None) -> dict:
    """``n_steps`` eager steps of an Engine on ``settings`` (sharded when
    ``mesh`` or the settings give one), with the launch counters at 0 just
    before them.  Returns {"losses", "z0" and "z" (numpy, before and after), "bitwise" (under a mesh:
    every step's latent on every rank equal to rank 0's), "launches" (per
    step, the K1 and K2 counts), "ms" (per step), "peak_mib" (CUDA) and
    "engine"}."""
    import torch

    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.parallel.mesh import ranks_bitwise_equal

    flat = lambda tree: torch.cat([t.detach().float().reshape(-1) for t in leaves(tree)]).cpu().numpy()
    with tempfile.TemporaryDirectory() as outdir:
        settings.outdir = outdir
        engine = Engine(settings, device=device, mesh=mesh)
        z0 = flat(engine.z)
        on_cuda = engine.device.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(engine.device)
        cuda_warp.reset_launch_counts()
        losses, launches, ms, bitwise = [], [], [], True
        for it in range(n_steps):
            before = dict(cuda_warp.LAUNCHES)
            t0 = time.perf_counter()
            engine.train(it)
            losses.append(float(engine.last_loss_values.float().sum()))
            if on_cuda:
                torch.cuda.synchronize(engine.device)
            ms.append(1e3 * (time.perf_counter() - t0))
            launches.append({k: v - before[k] for k, v in cuda_warp.LAUNCHES.items() if v != before[k]})
            if engine.mesh is not None:
                bitwise = ranks_bitwise_equal(leaves(engine.z), engine.mesh) and bitwise
    return {"losses": losses, "z0": z0, "z": flat(engine.z), "bitwise": bitwise, "launches": launches, "ms": ms,
            "peak_mib": torch.cuda.max_memory_allocated(engine.device) / 2**20 if on_cuda else None,
            "engine": engine}


def run_config(config: dict, n_steps: int, device="cuda", mesh_shape: str | None = None) -> dict:
    """:func:`trajectory` of a settings dict (the bench rows'), sharded over
    the process group on ``mesh_shape`` or unsharded (None), without the
    engine: what a spawned rank sends back."""
    from pixray_tpu_torch.config import apply_settings

    settings = apply_settings(dict(config, shard_cutouts=mesh_shape is not None, mesh_shape=mesh_shape or "auto",
                                   iterations=n_steps, steps_per_call=1), apply_side_effects=False)
    out = trajectory(settings, n_steps, device)
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
               names: list[str] | None = None, device="cuda") -> dict:
    """Sharded-vs-unsharded trajectory parity on ``mesh`` (the JAX
    ``run_parity``): the same seeded ``n_steps`` run sharded and then
    unsharded on this rank; per-step losses within ``loss_tol``, the final
    latent within ``z_tol`` of its largest value, every rank's latent
    bitwise rank 0's after every step.  Under FSDP the gathered tower
    weights must be the unsharded ones bit for bit.

    Returns {'shape', 'ensemble', 'fsdp', 'members', 'loss_delta', 'z_delta', 'loss0'}."""
    import torch

    from pixray_tpu_torch.parallel.ensemble import ensemble_active

    names = names or _names(mesh)
    n_cuts = num_cuts or 2 * mesh.size
    settings = lambda: tiny_settings(clip_models=",".join(names), num_cuts=n_cuts, iterations=n_steps)
    sharded = trajectory(settings(), n_steps, device, mesh)
    key = (tuple(names), n_cuts, n_steps, str(device))
    if key not in _baseline_memo:
        base = trajectory(settings(), n_steps, device)
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
            "loss0": sharded["losses"][0]}


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


def _rank_main(fn, args, kwargs, rank, world_size, port, results, env, threads, deadline):
    """One spawned rank: join the group through the PIXRAY_TPU_* variables,
    run ``fn``, report its result (or its traceback) to the parent."""
    import torch
    import torch.distributed as dist

    from pixray_tpu_torch.parallel.mesh import init_distributed

    os.environ.update(env, PIXRAY_TPU_COORDINATOR=f"127.0.0.1:{port}", PIXRAY_TPU_NUM_PROCESSES=str(world_size),
                      PIXRAY_TPU_PROCESS_ID=str(rank))
    torch.set_num_threads(threads)
    try:
        init_distributed(timeout_s=deadline)
        out = fn(*args, **kwargs)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, *args, deadline: float = 120.0, env: dict | None = None, threads: int = 1,
           **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world_size`` spawned ranks joined in
    one process group (on 127.0.0.1, a port from the OS); returns their
    results in rank order.  ``fn`` must be importable by its module's name.
    Each rank starts with ``OMP_NUM_THREADS`` = ``threads`` and ``env``.
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
                                                     dict(env or {}), threads, deadline), daemon=True)
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
    reports = launch(sweep, opts.ranks, deadline=opts.deadline, device=opts.device)[0]
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
