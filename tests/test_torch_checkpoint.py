"""Session checkpoint and resume in the port (``engine/checkpoint.py``) on the CPU.

- A checkpoint the JAX engine wrote (``--checkpoint_every 2``, DiffGrad,
  an LR drop at step 1) resumes in the port: the latent, every optimizer
  leaf (mapped from optax's ``inject_hyperparams`` layout), the
  iteration, the LR scale and the tracker equal the file's; then the
  next step, with the JAX engine's draws fed, gives the losses of a JAX
  engine resumed from the same file within 1e-4.  The JAX engine's own
  checkpoint records the step it has just run as the iteration to resume
  at, so both engines run that step again.
- A port round trip is bitwise: a run with ``--checkpoint_every 3`` (an
  LR drop at the same step) stopped after the checkpoint, and a fresh
  engine with ``--resume_from`` run to the end, give the per-step losses,
  the latent, the optimizer state and the tracker of one straight run, for
  the pixel latent under blocked dispatch (12 steps) and for clipdraw's
  dict latent with its per-group Adam (8 steps); the port's file carries
  its three generators.
- A wrong schema or drawer raises, and a file with a pickled object fails
  to load without running it.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine import checkpoint as CK
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.latent import leaves
from pixray_tpu_torch.engine.optimizers import state_tensors
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_engine import SLICE, _jax_step_draws
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    cfg = dict(SLICE, iterations=4, optimiser="DiffGrad", learning_rate_drops=["1i"], checkpoint_every=2,
               outdir=str(tmp_path))
    ref = JEngine(j_apply_settings(dict(cfg), apply_side_effects=False))
    for it in range(3):  # run()'s loop
        ref.cur_iteration = it
        ref.train(it)
    path = str(tmp_path / "session.ckpt")
    manifest = CK.read_manifest(path)
    assert manifest["iteration"] == 2 and manifest["drawer"] == "PixelDrawer" and "writer" not in manifest
    jp = ref.perceptors[0]
    weights = {"TinyTest": state_dict_from_flax(jp.variables["params"], jp.config)}

    resumed = dict(cfg, resume_from=path, checkpoint_every=0)
    j2 = JEngine(j_apply_settings(dict(resumed), apply_side_effects=False))
    port = Engine(apply_settings(dict(resumed), apply_side_effects=False), device="cpu", state_dicts=weights)
    assert "threefry key cannot be continued" in capsys.readouterr().out
    with np.load(path, allow_pickle=False) as z:
        np.testing.assert_array_equal(port.z.numpy(), z["z_0"])
        opt_leaves = [z[f"opt_{i}"] for i in range(manifest["n_opt_leaves"])]
    got = port.optimizer.jax_leaves(port.opt_state)
    assert len(got) == len(opt_leaves) == len(jax.tree_util.tree_leaves(j2.opt_state)) == 6
    for g, w in zip(got, opt_leaves):
        np.testing.assert_array_equal(g.numpy(), w)
    assert port.cur_iteration == j2.cur_iteration == 2
    assert float(port.lr_scale) == np.float32(j2.lr_scale) == np.float32(0.1)
    for field in ("best_loss", "best_iter", "num_loss_drop"):
        assert getattr(port.tracker, field) == getattr(j2.tracker, field), field
    assert port.tracker.num_loss_drop == 1

    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(j2.z_orig_flat))
    _, k_step = jax.random.split(j2.key)
    draws = _jax_step_draws(k_step, [32], cfg["num_cuts"], 96 / 54, cfg["batches"])
    j2.train(2)
    port.train(2, draws)
    np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(j2.last_loss_values), atol=1e-4)
    np.testing.assert_allclose(port.z.numpy(), np.asarray(j2.z), atol=1e-3)


ROUND_TRIP = dict(prompts="sunrise", clip_models="TinyTest", size=[64, 36], num_cuts=8, batches=1,
                  iterations=12, save_every=100, learning_rate_drops=["3i"], seed=3, init_noise="pixels",
                  vector_prompts="none", precision="fp32", save_intermediates=False)


def _steps(engine, first, last):
    """run()'s loop from ``first`` through ``last`` (the final checkin at
    ``iterations``); each step's losses."""
    losses = []
    for it in range(first, last + 1):
        engine.train(it)
        if it < engine.args.iterations:
            losses.append(engine.last_loss_values.clone())
    return losses


@pytest.mark.parametrize("drawer", [dict(drawer="pixel"), dict(drawer="clipdraw", strokes=12, iterations=8)],
                         ids=["pixel", "clipdraw"])
def test_port_resume_is_bitwise(tmp_path, drawer):
    def engine(label, **extra):
        (tmp_path / label).mkdir(exist_ok=True)
        return Engine(apply_settings(dict(ROUND_TRIP, outdir=str(tmp_path / label), **dict(drawer, **extra)),
                                     apply_side_effects=False), device="cpu")

    last = drawer.get("iterations", ROUND_TRIP["iterations"])
    straight = engine("straight")
    want = _steps(straight, 0, last)
    first = engine("first", checkpoint_every=3)
    got = _steps(first, 0, 3)
    path = str(tmp_path / "first" / "session.ckpt")
    assert CK.read_manifest(path)["iteration"] == 4
    resumed = engine("resumed", resume_from=path)
    assert resumed.cur_iteration == 4
    got += _steps(resumed, 4, last)
    if drawer["drawer"] == "pixel":
        assert straight.dispatched_blocks == [(4, 8)] and first.dispatched_blocks == []
        assert resumed.dispatched_blocks == [(4, 8)]
    assert len(got) == len(want) == last
    for it, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), it
    for a, b in zip(leaves(resumed.z) + state_tensors(resumed.opt_state),
                    leaves(straight.z) + state_tensors(straight.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(resumed.lr_scale, straight.lr_scale)
    assert resumed.tracker == straight.tracker


def _tamper(path, **edits):
    with np.load(path, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    arrays["manifest"] = CK._manifest_bytes(dict(CK.read_manifest(path), **edits))
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def test_wrong_schema_drawer_or_shape_raises(tmp_path):
    engine = Engine(apply_settings(dict(ROUND_TRIP, drawer="pixel", outdir=str(tmp_path)),
                                   apply_side_effects=False), device="cpu")
    path = str(tmp_path / "v.ckpt")
    CK.save_session(path, engine)
    manifest = CK.read_manifest(path)
    assert manifest["schema_version"] == CK.SCHEMA_VERSION == 3 and manifest["writer"] == CK.WRITER
    assert manifest["drawer"] == type(engine.drawer).__name__
    assert CK.restore_session(path, engine) == 0
    _tamper(path, schema_version=-1)
    with pytest.raises(ValueError, match="schema mismatch"):
        CK.restore_session(path, engine)
    _tamper(path, schema_version=3, drawer="ClipDrawer")
    with pytest.raises(ValueError, match="drawer"):
        CK.restore_session(path, engine)
    _tamper(path, drawer="PixelDrawer", n_opt_leaves=2)
    with pytest.raises(ValueError, match="2 optimizer leaves"):
        CK.restore_session(path, engine)


def test_restore_never_unpickles(tmp_path):
    class Boom:
        def __reduce__(self):
            return (os.system, ("touch " + str(tmp_path / "pwned"),))

    evil = tmp_path / "evil.ckpt"
    with open(evil, "wb") as f:
        pickle.dump({"schema_version": 3, "payload": Boom()}, f)
    with pytest.raises(Exception):
        CK.restore_session(str(evil), engine=None)
    evil2 = tmp_path / "evil2.ckpt"
    with open(evil2, "wb") as f:
        np.savez(f, manifest=np.array({"schema_version": 3}, dtype=object))
    with pytest.raises(ValueError, match="allow_pickle=False"):
        CK.restore_session(str(evil2), engine=None)
    assert not (tmp_path / "pwned").exists()
