"""What the ranks of ``tests/test_torch_parallel_slice.py`` run (spawned by
``pixray_tpu_torch.parallel.dryrun.launch``; this module imports no JAX,
and each rank asserts that none was imported)."""

import os
import pickle
import sys

import numpy as np
import torch

from pixray_tpu_torch.parallel import dryrun
from pixray_tpu_torch.parallel import mesh as PM


def _no_jax():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pixray_tpu"))
    assert not loaded, loaded


def toy_members(weights):
    """The toy towers of ``tests/test_ensemble.py``: tanh(flat(b) @ w)."""
    from pixray_tpu_torch.parallel.ensemble import EnsembleMember

    def fn(v, b):
        return torch.tanh(b.reshape(b.shape[0], -1).float() @ v["w"])

    return [EnsembleMember(f"Toy{i}", fn, w.shape[1]) for i, w in enumerate(weights)]


def ensemble_ranks(cases: list) -> list:
    """:func:`ensemble_rank` of each case on one (2, 2) mesh."""
    mesh = PM.build_mesh("2,2")
    out = [ensemble_rank(mesh, case) for case in cases]
    _no_jax()
    return out


def ensemble_rank(mesh, case: dict) -> dict:
    """The placed loss of ``test_matches_sequential_value_and_grad``: its
    value and this rank's part of the gradients to the batches and the
    pair batches."""
    from pixray_tpu_torch.engine.prompts import PromptTable
    from pixray_tpu_torch.parallel.ensemble import ensemble_scores

    members = toy_members(case["weights"])
    variables = [{"w": torch.tensor(w)} for w in case["weights"]]
    batches = [torch.tensor(b, requires_grad=True) for b in case["batches"]]
    pairs = [torch.tensor(b, requires_grad=True) for b in case["pair_batches"]]
    tables = [PromptTable.from_rows(rows, m.out_dim) for rows, m in zip(case["tables"], members)]
    vals, _ = ensemble_scores(mesh, members, {"main": batches}, {"main": tables}, variables,
                              pair_jobs={"imgp0": (pairs, case["pair_w"])})
    total = sum(torch.sum(vals["main"][p, :t.size]) for p, t in enumerate(tables)) + torch.sum(vals["imgp0"][:, 0])
    # a member of the other model group is not in this rank's graph: its part is 0
    grads = torch.autograd.grad(total, batches + pairs, allow_unused=True)
    return {"value": float(total), "grads": [np.zeros(b.shape, np.float32) if g is None else g.numpy()
                                             for b, g in zip(batches + pairs, grads)]}


def parity_rank(device: str) -> dict:
    """``run_parity`` on (4, 1) and (2, 2) over the 4 ranks, then on (2, 1)
    and FSDP (1, 2) over ranks 0-1 (ranks 2-3 sit those out); the 'hosts'
    mesh under LOCAL_WORLD_SIZE 2; ``run_sharded_step`` on (2, 2)."""
    reports = {}
    for shape, names in (("4,1", None), ("2,2", None), ("2,1", None), ("1,2", ["TinyTest"])):
        mesh = PM.build_mesh(shape)
        if mesh is not None:
            reports[shape] = dryrun.run_parity(mesh, names=names, device=device)
    hosts = PM.build_mesh("hosts")
    step = dryrun.run_sharded_step(PM.build_mesh("2,2"), device=device)
    _no_jax()
    return {"reports": reports, "hosts": hosts.shape, "hosts_index": (hosts.data_index, hosts.model_index),
            "local_rank": PM.local_rank(), "backend": torch.distributed.get_backend(), "step": step}


def _fed_engine(data: dict, settings: dict):
    """A port Engine on ``settings`` with the JAX engine's weights, latent
    and ``z_orig_flat`` from a slice payload."""
    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    port = Engine(apply_settings(dict(settings), apply_side_effects=False), device="cpu",
                  state_dicts={k: {n: torch.tensor(v) for n, v in sd.items()} for k, sd in data["weights"].items()})
    port.z = torch.tensor(data["z"])
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(data["z_orig_flat"])
    return port


def _fed_eager(data: dict, settings: dict):
    """:func:`_fed_engine` stepped eagerly through the payload's draws:
    (engine, each step's values, each step's latent)."""
    port = _fed_engine(data, settings)
    values, zs = [], []
    for it, draws in enumerate(data["draws"]):
        port.train(it, draws)
        values.append(port.last_loss_values.numpy().copy())
        zs.append(port.z.detach().numpy().copy())
    return port, values, zs


def _feed_draws(port, draws: list):
    """Make ``port.draw_step`` hand out ``draws`` in turn (the JAX engine's
    step draws), writing their noise planes where a block asks for them."""
    pending = iter(draws)

    def draw_step(planes_out=None):
        step = next(pending)
        if planes_out is not None:
            for batch, planes in zip(step, planes_out):
                for pd, out in zip(batch["perceptors"], planes):
                    for dst, src in zip(out, pd["noise"][1]):
                        dst.copy_(src)
        return step

    port.draw_step = draw_step


def blocked_slice_rank(payload: str) -> dict:
    """The port Engine sharded by the settings' ``mesh_shape``, fed the JAX
    engine's weights, latent and step draws from ``payload``: eager
    (``train(it, draws)``), and blocked by the settings' ``steps_per_call``
    with the same draws handed out by ``draw_step``."""
    with open(payload, "rb") as f:
        data = pickle.load(f)
    _eager, values, zs = _fed_eager(data, dict(data["settings"], steps_per_call=1))
    outdir = data["settings"]["outdir"] + "-blocked"
    os.makedirs(outdir, exist_ok=True)
    blocked = _fed_engine(data, dict(data["settings"], outdir=outdir))
    _feed_draws(blocked, data["draws"])
    blocked_values = []
    for it in range(len(data["draws"])):
        blocked.train(it)
        blocked_values.append(blocked.last_loss_values.numpy().copy())
    outdir = f"{data['settings']['outdir']}-unsharded-{torch.distributed.get_rank()}"
    os.makedirs(outdir)
    _unsharded, _, unsharded_zs = _fed_eager(data, dict(data["settings"], shard_cutouts=False, steps_per_call=1,
                                                         outdir=outdir))
    _no_jax()
    return {"values": values, "z": zs, "blocked_values": blocked_values, "blocked_z": blocked.z.detach().numpy(),
            "unsharded_z": unsharded_zs[-1],
            "blocks": blocked.dispatched_blocks, "mesh": blocked.mesh.shape, "names": list(blocked.loss_names)}


def blocked_ranks(cases: list, n_steps: int, steps_per_call: int) -> list:
    """Per (mesh shape, settings) case: the port sharded on the shape,
    eager and blocked by ``steps_per_call`` (None on a rank the mesh
    leaves out)."""
    out = []
    for shape, extra in cases:
        mesh = PM.build_mesh(shape)
        if mesh is None:
            out.append(None)
            continue
        runs = {}
        for name, spc in (("eager", 1), ("blocked", steps_per_call)):
            run = dryrun.trajectory(dryrun.tiny_settings(**dict(extra, iterations=n_steps)), n_steps, "cpu", mesh, spc)
            engine = run.pop("engine")
            runs[name] = dict(run, blocks=list(engine.dispatched_blocks), fsdp=len(engine.step_cfg.fsdp),
                              ensemble=engine.step_cfg.ensemble)
        out.append(runs)
    _no_jax()
    return out


def slice_rank(payload: str) -> dict:
    """The port Engine sharded by the settings' ``mesh_shape``, fed the JAX
    engine's weights, latent and step draws from ``payload`` (a pickle);
    with ``payload["unsharded"]`` also the port unsharded on them."""
    with open(payload, "rb") as f:
        data = pickle.load(f)
    port, values, zs = _fed_eager(data, data["settings"])
    out = {"values": values, "z": zs, "names": list(port.loss_names), "mesh": port.mesh.shape,
           "num_cuts": port.args.num_cuts, "ensemble": port.step_cfg.ensemble,
           "lr": getattr(port.drawer, "learning_rate", None) or port.args.learning_rate}  # the optimizer's
    if data.get("unsharded"):  # every rank writes its own files then
        outdir = f"{data['settings']['outdir']}-unsharded-{torch.distributed.get_rank()}"
        os.makedirs(outdir)
        settings = dict(data["settings"], shard_cutouts=False, outdir=outdir)
        _port, out["base_values"], out["base_z"] = _fed_eager(data, settings)
    _no_jax()
    return out


def plugins_rank(cases: list, n_steps: int) -> list:
    """Per (mesh shape, settings) case: the port sharded on the shape
    against itself unsharded (None on a rank the mesh leaves out)."""
    out = []
    for shape, extra in cases:
        mesh = PM.build_mesh(shape)
        if mesh is None:
            out.append(None)
            continue
        settings = lambda: dryrun.tiny_settings(**dict(extra, iterations=n_steps))
        sharded = dryrun.trajectory(settings(), n_steps, "cpu", mesh)
        base = dryrun.trajectory(settings(), n_steps, "cpu")
        gap = dryrun.agreement(sharded, base)
        out.append({"loss_delta": gap["loss"], "z_delta": gap["z"], "bitwise": sharded["bitwise"],
                    "names": list(sharded["engine"].loss_names), "base_names": list(base["engine"].loss_names)})
    _no_jax()
    return out


def raise_on_rank(rank: int):
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


def unbuildable_engines(shapes: list) -> list:
    """The ValueError of an Engine on each ``--mesh_shape`` (it must raise)."""
    from pixray_tpu_torch.engine.core import Engine

    errors = []
    for shape in shapes:
        try:
            Engine(dryrun.tiny_settings(shard_cutouts=True, mesh_shape=shape), device="cpu")
        except ValueError as exc:
            errors.append(str(exc))
        else:
            raise AssertionError(f"mesh_shape {shape!r} built an engine")
    return errors


def hang(seconds: float):
    import time

    time.sleep(seconds)

