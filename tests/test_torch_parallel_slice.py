"""The port's parallel layer across processes, on the CPU: ranks spawned by
``pixray_tpu_torch.parallel.dryrun.launch`` (one thread each, ports from the
OS, gloo), each launch under a deadline after which its ranks are killed.
Every multi-process test lives in this file, so that ``--dist loadfile``
never runs two process groups at once.

- ``ensemble_scores`` on a (2, 2) group against the JAX ``ensemble_scores``
  on a (2, 2) virtual mesh, with the toy members of ``tests/test_ensemble.py``:
  2 members, and 3 members on 2 groups; the value, and the ranks' gradient
  parts summed against the JAX gradients (the canary's tolerances).
- ``run_parity`` on (4, 1), (2, 2) (3 tiny towers placed), (2, 1) and FSDP
  (1, 2) (one tower) at 2e-3, and ``run_sharded_step``.
- The port Engine sharded by ``--mesh_shape`` (2, 1) with TinyTest and
  (2, 2) with three towers, fed the JAX engine's weights, latent and draws,
  against the unsharded JAX Engine: 2 steps, batches 2, ``init_weight_dist``
  (added once, not once per rank); losses atol 1e-4, latent atol 1e-3, and
  every rank's latent bitwise the same.  Each mesh also with a spot
  prompt, an image prompt and the aesthetic loss on a live head (the
  spot bank on a chunk, the gathered prompt-image embeddings or pair job,
  the gathered or replicated ``embeds``).
- The plug-ins under a mesh, against the unsharded port: custom losses that
  read the gathered embeddings, an image prompt and a spot prompt.
- ``init_distributed`` through the PIXRAY_TPU_* variables with a 'hosts'
  mesh of 2 x 2 (``LOCAL_WORLD_SIZE`` 2).
- No fallback: a rank that raises, a rank that hangs past the deadline and
  an Engine whose ``--mesh_shape`` cannot be built fail the launch.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as R
from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.engine.prompts import PromptTable as JPromptTable
from pixray_tpu.parallel.ensemble import EnsembleMember as JMember
from pixray_tpu.parallel.ensemble import ensemble_scores as j_ensemble_scores
from pixray_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.parallel.dryrun import launch
from test_torch_engine import _jax_step_draws
from test_torch_image_slice import jax_image_draws, write_png
from torch_parity import jax_perceptor_cache  # noqa: F401

DEADLINE = 120.0
TOL = 2e-3  # run_parity's loss and latent tolerances


def in_background(fn, *args, **kwargs):
    """``launch`` in a thread (its ranks run while this process computes
    the JAX side); ``.result()`` waits for it."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(launch, fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


# ---------------------------------------------------------------- ensemble_scores
TOYS = [("ToyA", 8, 16), ("ToyB", 12, 24), ("ToyC", 8, 20)]


def _ensemble_case(n_members):
    """The canary's inputs, drawn in its order (members, batches, pair
    batches, tables), for the first ``n_members`` toy towers."""
    rng = np.random.default_rng(0)
    specs = TOYS[:n_members]
    weights = [(rng.standard_normal((r * r * 3, d)) / r).astype(np.float32) for _n, r, d in specs]
    n = 8
    batches = [rng.uniform(size=(n, r, r, 3)).astype(np.float32) for _n, r, _d in specs]
    pair_batches = [rng.uniform(size=(n, r, r, 3)).astype(np.float32) for _n, r, _d in specs]
    tables = [[(rng.standard_normal(d).astype(np.float32), 1.0 if i % 2 == 0 else -0.5, float("-inf"))
               for i in range(k)] for (_n, _r, d), k in zip(specs, [2, 3, 1])]
    return {"weights": weights, "batches": batches, "pair_batches": pair_batches, "tables": tables,
            "pair_w": [0.8, -0.6, 0.5][:n_members]}


def _jax_ensemble(case):
    devices = jax.devices("cpu")
    mesh = Mesh(np.asarray(devices[:4]).reshape(2, 2), (DATA_AXIS, MODEL_AXIS))
    members = [JMember(f"Toy{i}", lambda v, b: jnp.tanh(b.reshape(b.shape[0], -1).astype(jnp.float32) @ v["w"]),
                       w.shape[1]) for i, w in enumerate(case["weights"])]
    variables = [{"w": jnp.asarray(w)} for w in case["weights"]]
    tables = [JPromptTable.from_rows(rows) for rows in case["tables"]]

    def placed(batches, pair_batches):
        vals, _ = j_ensemble_scores(mesh, members, {"main": list(batches)}, {"main": tables}, variables,
                                    pair_jobs={"imgp0": (list(pair_batches), case["pair_w"])})
        return sum(jnp.sum(vals["main"][p, :t.size]) for p, t in enumerate(tables)) + jnp.sum(vals["imgp0"][:, 0])

    value, grads = jax.value_and_grad(placed, argnums=(0, 1))(
        tuple(jnp.asarray(b) for b in case["batches"]), tuple(jnp.asarray(b) for b in case["pair_batches"]))
    return float(value), [np.asarray(g) for g in grads[0] + grads[1]]


@pytest.fixture(scope="module")
def ensemble_runs():
    cases = {n: _ensemble_case(n) for n in (2, 3)}
    ranks = in_background(R.ensemble_ranks, 4, [cases[2], cases[3]], deadline=DEADLINE)
    jax_out = {n: _jax_ensemble(case) for n, case in cases.items()}
    return jax_out, ranks.result()


@pytest.mark.parametrize("n_members", [2, 3], ids=["two members", "three members on two groups"])
def test_ensemble_scores_match_jax(ensemble_runs, n_members):
    jax_out, ranks = ensemble_runs
    value, grads = jax_out[n_members]
    per_rank = [r[n_members - 2] for r in ranks]
    for r in per_rank:
        np.testing.assert_allclose(r["value"], value, rtol=2e-5)
    summed = [sum(r["grads"][i] for r in per_rank) for i in range(len(grads))]
    for got, want in zip(summed, grads):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)
    # a rank's part is its own: the members of the other model group leave it zero
    owned = [[p % 2 == (rank % 2) for p in range(n_members)] for rank in range(4)]
    for rank, r in enumerate(per_rank):
        for p in range(n_members):
            assert bool(np.any(r["grads"][p])) == owned[rank][p]


# ---------------------------------------------------------------- run_parity, 'hosts'
@pytest.fixture(scope="module")
def parity_runs():
    return launch(R.parity_rank, 4, "cpu", deadline=DEADLINE, env={"LOCAL_WORLD_SIZE": "2"})


@pytest.mark.parametrize("shape, ensemble, fsdp", [("4,1", False, 0), ("2,2", True, 0), ("2,1", False, 0),
                                                   ("1,2", False, 1)])
def test_run_parity(parity_runs, shape, ensemble, fsdp):
    d, m = (int(x) for x in shape.split(","))
    for rank, out in enumerate(parity_runs):
        if rank >= d * m:
            assert shape not in out["reports"]
            continue
        rep = out["reports"][shape]
        assert rep["shape"] == {"data": d, "model": m}
        assert (rep["ensemble"], rep["fsdp"]) == (ensemble, fsdp)
        assert rep["members"] == (3 if ensemble else 1)
        assert rep["loss_delta"] <= TOL and rep["z_delta"] <= TOL
        assert np.isfinite(out["step"])


def test_init_distributed_hosts_mesh(parity_runs):
    for rank, out in enumerate(parity_runs):
        assert out["hosts"] == {"data": 2, "model": 2}
        assert out["hosts_index"] == (rank // 2, rank % 2)
        assert out["local_rank"] == rank % 2
        assert out["backend"] == "gloo"


# ---------------------------------------------------------------- the slice against the JAX engine
SLICE = dict(
    drawer="pixel", prompts="sunrise", size=[96, 54], num_cuts=8, batches=2, iterations=2,
    save_every=100000, display_every=100000, init_noise=None, vector_prompts="none", seed=1,
    save_intermediates=False, learning_rate_drops=[], precision="fp32", steps_per_call=1, init_weight_dist=0.2,
)


THREE_TOWERS = "TinyTest,TinyTest48,TinyTestDim48"
# the mesh-only paths: a spot bank on a chunk, an image prompt (its
# embeddings gathered over the data group, a pair job under placement) and
# the aesthetic loss, which reads the last tower's embeddings (gathered
# with their gradient, or one replicated encode under placement), with a
# head of that tower's width so that the term moves the latent
PLUGINS = dict(spot_prompts="a face", custom_loss="aesthetic", image_prompt_weight=0.7)


@pytest.mark.usefixtures("jax_perceptor_cache")
@pytest.mark.parametrize("shape, towers, plugins", [
    pytest.param("2,1", "TinyTest", False, id="2,1-TinyTest"),
    pytest.param("2,2", THREE_TOWERS, False, id=f"2,2-{THREE_TOWERS}"),
    pytest.param("2,1", "TinyTest", True, id="2,1-TinyTest-spot-image-aesthetic"),
    pytest.param("2,2", THREE_TOWERS, True, id=f"2,2-{THREE_TOWERS}-spot-image-aesthetic"),
])
def test_sharded_slice_matches_unsharded_jax_engine(tmp_path, monkeypatch, shape, towers, plugins):
    cfg = dict(SLICE, clip_models=towers)
    env = {}
    if plugins:
        models = tmp_path / "models"
        models.mkdir()
        dim = 48 if towers.endswith("Dim48") else 32  # the last tower's embedding width
        rng = np.random.default_rng(4)
        torch.save({"weight": torch.tensor(rng.standard_normal((1, dim)).astype(np.float32)),
                    "bias": torch.tensor([0.5])}, models / "ava_vit_b_16_linear.pth")
        env["PIXRAY_TPU_MODELS"] = str(models)
        monkeypatch.setenv("PIXRAY_TPU_MODELS", str(models))
        cfg.update(PLUGINS, image_prompts=write_png(tmp_path / "prompt.png", (30, 40, 3), "RGB", 5))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, shard_cutouts=False, outdir=str(tmp_path / "jax")),
                                   apply_side_effects=False))
    payload = {
        "settings": dict(cfg, shard_cutouts=True, mesh_shape=shape, outdir=str(tmp_path / "port")),
        "weights": {p.name: {k: np.asarray(v) for k, v in state_dict_from_flax(p.variables["params"], p.config).items()}
                    for p in ref.perceptors},
        "z": np.asarray(ref.z), "z_orig_flat": np.asarray(ref.z_orig_flat), "draws": [], "unsharded": plugins,
    }
    sizes = [p.input_resolution for p in ref.perceptors]
    # the banks each tower draws for: main, and with the plug-ins spot and one image prompt
    specs = [SimpleNamespace(cut_size=s, spot_banks=(True, False), n_image_prompts=1) for s in sizes]
    key = ref.key
    for _ in range(cfg["iterations"]):  # each step's key, as the JAX engine splits it
        key, k_step = jax.random.split(key)
        payload["draws"].append(
            jax_image_draws(k_step, specs, cfg["num_cuts"], 96 / 54, cfg["batches"], False) if plugins
            else _jax_step_draws(k_step, sizes, cfg["num_cuts"], 96 / 54, cfg["batches"]))
    path = tmp_path / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    d, m = (int(x) for x in shape.split(","))
    running = in_background(R.slice_rank, d * m, str(path), deadline=DEADLINE, env=env)
    want_values, want_z = [], []
    for it in range(cfg["iterations"]):
        ref.train(it)
        want_values.append(np.asarray(ref.last_loss_values))
        want_z.append(np.asarray(ref.z))
    ranks = running.result()
    for out in ranks:
        assert out["mesh"] == {"data": d, "model": m} and out["ensemble"] == (m > 1)
        assert out["names"] == ref.loss_names and "init_weight_dist" in out["names"]
        if plugins:
            assert {"TinyTest:spot0", "TinyTest:image_prompt0", "loss:AestheticLoss"} <= set(out["names"])
        for got, want in zip(out["values"], want_values):
            np.testing.assert_allclose(got, want, atol=1e-4)
        if plugins:
            # the JAX engine through the image-prompt and spot banks is held as
            # tests/test_torch_image_slice.py holds it (Adam's first steps move
            # an element whose gradient is ~1e-7 by up to lr either way, which
            # the unsharded port shows against it too); the sharding itself is
            # held to the unsharded port on the same draws
            for it, (got, want) in enumerate(zip(out["z"], want_z)):
                diff = np.abs(got - want)
                assert (diff > 1e-3).mean() <= 1e-3 and diff.max() <= 2 * out["lr"], (it, int((diff > 1e-3).sum()))
            for got, want in zip(out["values"], out["base_values"]):
                np.testing.assert_allclose(got, want, atol=1e-5)
            for got, want in zip(out["z"], out["base_z"]):
                np.testing.assert_allclose(got, want, atol=1e-4)
        else:
            for got, want in zip(out["z"], want_z):
                np.testing.assert_allclose(got, want, atol=1e-3)
        for got, first in zip(out["z"], ranks[0]["z"]):
            assert got.tobytes() == first.tobytes()
    if plugins:  # the aesthetic term is live: its head reads the embeddings
        assert abs(want_values[0][ref.loss_names.index("loss:AestheticLoss")]) > 0.1
    assert (tmp_path / "port" / "output.png").exists()


# ---------------------------------------------------------------- plug-ins, image and spot prompts
@pytest.fixture(scope="module")
def plugin_runs(tmp_path_factory):
    from PIL import Image

    path = str(tmp_path_factory.mktemp("images") / "prompt.png")
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(path)
    extra = dict(custom_loss="aesthetic,smoothness:0.5,saturation", image_prompts=path, spot_prompts="a face",
                 batches=2, init_weight_dist=0.1, num_cuts=8)
    cases = [("2,1", dict(extra, clip_models="TinyTest")), ("2,2", dict(extra, clip_models="TinyTest,TinyTest48")),
             ("1,2", dict(extra, clip_models="TinyTest"))]
    return cases, launch(R.plugins_rank, 4, cases, 2, deadline=DEADLINE)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["data parallel", "ensemble placement", "FSDP"])
def test_plugins_under_a_mesh_match_unsharded(plugin_runs, case):
    cases, ranks = plugin_runs
    shape = cases[case][0]
    d, m = (int(x) for x in shape.split(","))
    for rank, out in enumerate(ranks[:d * m]):
        rep = out[case]
        assert rep["names"] == rep["base_names"]
        assert {"TinyTest:image_prompt0", "TinyTest:spot0"} <= set(rep["names"])
        for loss in ("AestheticLoss", "SmoothnessLoss", "SaturationLoss"):  # some give a list of terms
            assert any(n.startswith(f"loss:{loss}") for n in rep["names"]), rep["names"]
        assert rep["bitwise"]
        assert rep["loss_delta"] <= TOL and rep["z_delta"] <= TOL, rep
    for out in ranks[d * m:]:
        assert out[case] is None


# ---------------------------------------------------------------- failure fails
def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 .*fails on purpose"):
        launch(R.raise_on_rank, 2, 1, deadline=60.0)


def test_a_hung_rank_is_killed_at_the_deadline():
    with pytest.raises(TimeoutError, match="deadline"):
        launch(R.hang, 2, 600.0, deadline=6.0)


def test_engine_refuses_an_unbuildable_mesh_shape():
    for errors in launch(R.unbuildable_engines, 2, ["4,1", "1"], deadline=60.0):
        assert "mesh_shape (4, 1) needs 4 devices, have 2" in errors[0]
        assert "mesh_shape '1' does not span the 2 ranks" in errors[1]
