"""Session checkpoint and resume (port of ``pixray_tpu/engine/checkpoint.py``).

The JAX package's format, schema v3: one ``.npz`` holding a ``manifest``
entry (UTF-8 JSON bytes: the schema version, build stamps, the drawer's
class name and the scalar state) and the leaves of the latent (``z_i``)
and of the optimizer state (``opt_i``) in the JAX package's optax leaf
order (``optimizer.jax_leaves``: inject_hyperparams' count and learning
rate, then the inner state's count and moments; per group for the stroke
drawers).  Every load passes ``allow_pickle=False``: an untrusted file can
fail to parse but never runs code.

The port reads what the JAX engine wrote.  A JAX file's threefry ``key``
cannot be continued by the port's generators: the port says so and draws
on from its own seeded generators.  The port's own files add the state of
its three generators (the host and the device ``torch.Generator`` as
``torch_gen`` / ``torch_gen_device``, the numpy generator in the manifest)
and the step whose loss the best-loss tracker reads next, so a run resumed
from a port checkpoint continues the uninterrupted run exactly.

Restore copies into the engine's own tensors (a captured block holds
their addresses).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from pixray_tpu_torch import __version__
from pixray_tpu_torch.engine.latent import leaves

# the JAX package's SCHEMA_VERSION: restore refuses other versions
SCHEMA_VERSION = 3
WRITER = "pixray_tpu_torch"


def _manifest_bytes(manifest: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8)


def _manifest(z, path: str) -> dict:
    if "manifest" not in z.files:
        raise ValueError(f"{path!r} is not a pixray_tpu checkpoint (no manifest entry)")
    return json.loads(bytes(z["manifest"]).decode("utf-8"))


def read_manifest(path: str) -> dict:
    """The JSON manifest of a checkpoint, without reading the arrays."""
    with np.load(path, allow_pickle=False) as z:
        return _manifest(z, path)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_session(path: str, engine, iteration: int | None = None) -> None:
    """Write the engine's resumable state to ``path``.  ``iteration``: the
    step to resume at (default ``engine.cur_iteration``)."""
    z_leaves = [_host(t) for t in leaves(engine.z)]
    opt_leaves = [_host(t) for t in engine.optimizer.jax_leaves(engine.opt_state)]
    pending = engine._pending_loss
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "writer": WRITER,
        "torch_version": torch.__version__,
        "repo_version": __version__,
        "drawer": type(engine.drawer).__name__,
        "n_z_leaves": len(z_leaves),
        "n_opt_leaves": len(opt_leaves),
        "iteration": int(engine.cur_iteration if iteration is None else iteration),
        "lr_scale": float(engine.lr_scale),
        "seed_used": engine.seed_used,
        "tracker": {
            "best_loss": float(engine.tracker.best_loss),
            "best_iter": int(engine.tracker.best_iter),
            "num_loss_drop": int(engine.tracker.num_loss_drop),
        },
        "pending_loss": None if pending is None else [int(pending[0]), float(pending[1])],
        "numpy_rng": engine.np_rng.bit_generator.state,
        "torch_gen_device_type": engine.gen_device.device.type,
    }
    arrays = {"manifest": _manifest_bytes(manifest),
              "torch_gen": engine.gen.get_state().numpy(),
              "torch_gen_device": engine.gen_device.get_state().numpy()}
    arrays.update({f"z_{i}": leaf for i, leaf in enumerate(z_leaves)})
    arrays.update({f"opt_{i}": leaf for i, leaf in enumerate(opt_leaves)})

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # np.savez appends .npz to a bare path; the user's path must round-trip
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _copy_leaves(name: str, dsts: list, srcs: list) -> None:
    if len(dsts) != len(srcs):
        raise ValueError(f"checkpoint holds {len(srcs)} {name} leaves, the engine {len(dsts)}")
    for i, (dst, src) in enumerate(zip(dsts, srcs)):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"checkpoint {name} leaf {i} has shape {src.shape}, the engine {tuple(dst.shape)}")
    with torch.no_grad():
        for dst, src in zip(dsts, srcs):
            dst.copy_(torch.from_numpy(np.array(src)))


def restore_session(path: str, engine) -> int:
    """Restore a session saved by this package or by the JAX package into a
    freshly built engine of the same configuration; returns the iteration
    to resume at."""
    with np.load(path, allow_pickle=False) as z:
        state = _manifest(z, path)
        got = state.get("schema_version")
        if got != SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint schema mismatch: file has version {got!r} (saved by repo "
                f"{state.get('repo_version', '?')}, {state.get('writer', 'jax ' + str(state.get('jax_version', '?')))}),"
                f" this build expects {SCHEMA_VERSION}. Re-render or convert the session.")
        want_drawer = type(engine.drawer).__name__
        if state.get("drawer", want_drawer) != want_drawer:
            raise ValueError(f"checkpoint was saved with drawer {state['drawer']!r} but the engine is configured "
                             f"with {want_drawer!r} — restore with the same --drawer.")
        z_leaves = [z[f"z_{i}"] for i in range(int(state["n_z_leaves"]))]
        opt_leaves = [z[f"opt_{i}"] for i in range(int(state["n_opt_leaves"]))]
        gens = {k: z[k] for k in ("torch_gen", "torch_gen_device") if k in z.files}

    _copy_leaves("latent", leaves(engine.z), z_leaves)
    _copy_leaves("optimizer", engine.optimizer.jax_leaves(engine.opt_state), opt_leaves)
    engine.lr_scale.fill_(float(state["lr_scale"]))
    engine.cur_iteration = int(state["iteration"])
    tracker = state["tracker"]
    engine.tracker.best_loss = float(tracker["best_loss"])
    engine.tracker.best_iter = int(tracker["best_iter"])
    engine.tracker.num_loss_drop = int(tracker["num_loss_drop"])
    pending = state.get("pending_loss")
    engine._pending_loss = None if pending is None else (int(pending[0]), float(pending[1]))

    if state.get("writer") != WRITER:
        print("checkpoint written by the JAX package: its threefry key cannot be continued by this port's "
              "generators, which draw on from their own seed")
        return engine.cur_iteration
    engine.np_rng.bit_generator.state = state["numpy_rng"]
    engine.gen.set_state(torch.from_numpy(gens["torch_gen"]))
    if state["torch_gen_device_type"] == engine.gen_device.device.type:
        engine.gen_device.set_state(torch.from_numpy(gens["torch_gen_device"]))
    else:
        print(f"checkpoint written on {state['torch_gen_device_type']}: its device generator cannot be continued "
              f"on {engine.gen_device.device.type}, which draws on from its own seed")
    return engine.cur_iteration
