"""The port's mesh (``pixray_tpu_torch/parallel/mesh.py``) in one process:
mesh sizes against the JAX ``build_mesh`` on the CPU's virtual devices
(including the shapes it refuses), ``pad_cuts_for_mesh`` against JAX,
``init_distributed`` with nothing configured, the FSDP rule splitting and
rejoining every leaf of a tiny tower bit for bit (by concatenation and by
the -0.0-filled sum the gather runs), and an Engine refusing a
``--mesh_shape`` it cannot build.  The process groups themselves are
tested across processes in ``tests/test_torch_parallel_slice.py``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixray_tpu.parallel import mesh as J
from pixray_tpu_torch.models.perceptor import Perceptor
from pixray_tpu_torch.parallel import dryrun
from pixray_tpu_torch.parallel import mesh as M

SHAPES = ["auto", "", "4", "2,2", "4,2", "8", "1", "1,1", "hosts"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_dims_match_jax_build_mesh(shape, n):
    devices = jax.devices("cpu")[:n]
    try:
        ref = J.build_mesh(shape, devices=devices)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).replace("(", r"\(").replace(")", r"\)")):
            M.mesh_dims(shape, n)
        return
    want = None if ref is None else (ref.shape[J.DATA_AXIS], ref.shape[J.MODEL_AXIS])
    assert M.mesh_dims(shape, n) == want


def test_hosts_shape_is_hosts_by_local_ranks():
    assert M.mesh_dims("hosts", 8, hosts=2) == (2, 4)
    assert M.mesh_dims("hosts", 4, hosts=4) == (4, 1)


@pytest.mark.parametrize("num_cuts", [1, 7, 8, 30, 64])
@pytest.mark.parametrize("d, m", [(2, 1), (4, 2), (3, 1), (1, 4)])
def test_pad_cuts_match_jax(num_cuts, d, m):
    ref_mesh = Mesh(np.asarray(jax.devices("cpu")[:d * m]).reshape(d, m), (J.DATA_AXIS, J.MODEL_AXIS))
    mesh = M.Mesh({M.DATA_AXIS: d, M.MODEL_AXIS: m}, 0, 0, 0, None, None, None)
    assert M.pad_cuts_for_mesh(num_cuts, mesh) == J.pad_cuts_for_mesh(num_cuts, ref_mesh)
    assert M.pad_cuts_for_mesh(num_cuts, None) == J.pad_cuts_for_mesh(num_cuts, None) == num_cuts


def test_shard_cutout_batch_takes_the_data_index_rows():
    bank = torch.arange(8 * 3).reshape(8, 3)
    for d in range(4):
        mesh = M.Mesh({M.DATA_AXIS: 4, M.MODEL_AXIS: 2}, 2 * d, d, 0, None, None, None)
        assert torch.equal(M.shard_cutout_batch(bank, mesh), bank[2 * d:2 * d + 2])
    assert M.shard_cutout_batch(bank, None) is bank


DIST_VARS = ("PIXRAY_TPU_COORDINATOR", "PIXRAY_TPU_NUM_PROCESSES", "PIXRAY_TPU_PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_init_distributed_is_a_no_op_unconfigured(monkeypatch):
    for name in DIST_VARS:
        monkeypatch.delenv(name, raising=False)
    assert M.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert M.world() == (0, 1) and M.local_rank() == 0
    assert M.build_mesh("auto") is None


def test_init_distributed_refuses_half_a_configuration(monkeypatch):
    for name in DIST_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PIXRAY_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes, process_id"):
        M.init_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("m", [2, 4])
def test_fsdp_rule_splits_and_rejoins_every_leaf(m):
    tower = Perceptor("TinyTest", "cpu", torch.float32).model.visual
    leaves = list(tower.parameters()) + list(tower.buffers())
    split = 0
    for t in leaves:
        x = t.detach().clone()
        x.view(-1)[0] = -0.0  # a signed zero survives the gather's sum
        axis = M.shard_axis(x.shape, m)
        if axis is None:
            assert x.ndim < 2 or all(s % m for s in x.shape)
            continue
        assert x.shape[axis] == max(s for s in x.shape if s % m == 0)
        size = x.shape[axis] // m
        pieces = [x.narrow(axis, i * size, size) for i in range(m)]
        assert torch.equal(torch.cat(pieces, axis).view(-1).view(torch.uint8), x.view(-1).view(torch.uint8))
        summed = torch.full(x.shape, -0.0)
        for i, piece in enumerate(pieces):  # what gather_along's all_reduce adds up
            placed = torch.full(x.shape, -0.0)
            placed.narrow(axis, i * size, size).copy_(piece)
            summed = summed + placed
        assert torch.equal(summed.view(-1).view(torch.uint8), x.view(-1).view(torch.uint8))
        split += 1
    assert split >= len([t for t in leaves if t.ndim >= 2]) - 1  # the class embedding alone stays whole


def test_engine_refuses_a_mesh_shape_it_cannot_build():
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 1\) needs 2 devices, have 1"):
        dryrun.trajectory(dryrun.tiny_settings(shard_cutouts=True, mesh_shape="2"), 1, "cpu")
    run = dryrun.trajectory(dryrun.tiny_settings(shard_cutouts=True, mesh_shape="auto"), 1, "cpu")
    assert run["engine"].mesh is None and np.isfinite(run["losses"][0])


# ---------------------------------------------------------------- the dispatch rule under a mesh
@pytest.mark.parametrize("device, backend, want", [
    ("cpu", "gloo", 0),  # the tests and the dry run: blocks, each its steps in a loop
    ("cuda", "nccl", 0),  # one card per rank: one CUDA graph per block, the collectives inside
    ("cuda", "gloo", 1),  # ranks sharing one card: gloo runs on the host, so every step is eager
])
def test_mesh_dispatch_rule(device, backend, want, monkeypatch):
    """The engine's rule, with the group's backend stubbed (no card and no
    group is needed to decide it)."""
    from pixray_tpu_torch.engine import core

    monkeypatch.setattr(M.dist, "get_backend", lambda group=None: backend)
    mesh = M.Mesh({M.DATA_AXIS: 2, M.MODEL_AXIS: 1}, 0, 0, 0, object(), None, None)
    args = dryrun.tiny_settings(steps_per_call=0)
    said = core.mesh_dispatch(args, mesh, torch.device(device))
    assert args.steps_per_call == want
    assert said.startswith(backend) and ("eager" in said) == (want == 1)
    assert M.step_capturable(mesh) == (backend == "nccl")


def test_one_rank_mesh_needs_a_group_of_one():
    with pytest.raises(ValueError, match="process group of one rank"):
        M.one_rank_mesh()


@pytest.fixture
def one_rank_gloo():
    """A 1-rank gloo group in this process, destroyed after the test."""
    M.init_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_mesh_smoke_on_one_gloo_rank(one_rank_gloo):
    """``dryrun.mesh_smoke("cpu")``: the sharded step on a (1, 1) mesh, and
    sharded-vs-unsharded parity eager and blocked (an eager step, then two
    blocks of 4, each its steps in a loop on the CPU)."""
    mesh = M.one_rank_mesh()
    assert mesh.shape == {M.DATA_AXIS: 1, M.MODEL_AXIS: 1} and not M.step_capturable(mesh)
    out = dryrun.mesh_smoke("cpu")
    assert out["backend"] == "gloo" and np.isfinite(out["loss"])
    for kind in ("eager", "blocked"):
        rep = out[kind]
        assert rep["shape"] == {M.DATA_AXIS: 1, M.MODEL_AXIS: 1} and rep["members"] == 1
        assert rep["loss_delta"] <= 2e-3 and rep["z_delta"] <= 2e-3
    assert out["eager"]["blocks"] == []
    assert out["blocked"]["blocks"] == [(1, 4), (5, 4)]


def test_sharded_blocks_rehearsed_on_one_gloo_rank(one_rank_gloo):
    """``dryrun.sharded_blocks``, which ``chip_smoke.py`` runs at the pixel
    row's width on a 1-rank NCCL group, on the CPU at dry-run scale: the
    three runs and the block structure, each block's first step bitwise
    the eager sharded step from the state it started from, and at
    learning-rate scale 0 a block bitwise its eager steps with the latent
    kept (on the CPU a block is its steps in a loop, so the eager and the
    blocked sharded runs are bitwise too)."""
    config = dict(drawer="pixel", prompts="a sunrise", clip_models="TinyTest", size=[64, 36], save_every=1000,
                  init_noise=None, vector_prompts="none", num_cuts=4, seed=7, save_intermediates=False,
                  learning_rate_drops=[], precision="fp32")
    out = dryrun.sharded_blocks(config, n_steps=9, block=4, device="cpu")
    runs = out["runs"]
    assert out["backend"] == "gloo"
    assert runs["eager"]["blocks"] == []
    for name in ("blocked", "unsharded", "unsharded2"):
        assert runs[name]["blocks"] == [(1, 4), (5, 4)] and sorted(runs[name]["block_z"]) == [1, 5]
    assert out["starts"] == {1: True, 5: True} and out["moved"]
    assert out["lr0"] == {"blocks": [(1, 4)], "values_bitwise": [True] * 4, "latent_kept": True}
    assert runs["blocked"]["losses"] == runs["eager"]["losses"]
    assert runs["blocked"]["z"].tobytes() == runs["eager"]["z"].tobytes()
    gap = dryrun.agreement(runs["blocked"], runs["unsharded"])
    assert gap["loss"] <= 2e-3 and gap["z"] <= 2e-3
