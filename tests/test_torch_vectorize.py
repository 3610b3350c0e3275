"""The port's vectorize tool against ``pixray_tpu.tools.vectorize``.

- ``--avg-diff``: the output file equals the JAX tool's, byte for byte;
- ``svm_normal`` (L-BFGS-B on the primal, no sklearn) solves the problem
  of sklearn's ``LinearSVC(C=1.0)``: against liblinear run to tol 1e-10,
  within 1e-6 of max|w| on separable and overlapping seeded sets;
- ``--svm-diff`` against the JAX tool, whose liblinear stops at its
  default tol 1e-4, short of the minimum: on seeds 0-9 the measured gaps
  were up to 3.0e-2 of max|v| with cosine ≥ 1 − 1.2e-4 on the separable
  8×16 sets (5 of 10 below 2e-10) and up to 5.9e-4 with cosine ≥ 1 − 1.6e-7
  on the overlapping 20×32 sets; held to 5e-2 / 1 − 5e-4 and 2e-3 /
  1 − 1e-6;
- ``spew_vectors``: the JAX TinyTest weights carried across by the bridge,
  both packages in f32, rows within 1e-5 (unit norm).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from sklearn import svm

from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu.tools import vectorize as JV
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.perceptor import Perceptor
from pixray_tpu_torch.tools import vectorize as V


def _sets(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "separable":
        return rng.random((8, 16)) - 2, rng.random((8, 16)) + 2
    return rng.standard_normal((20, 32)), rng.standard_normal((20, 32)) + 0.3


def _write_pair(tmp_path, tables):
    f1, f2 = tmp_path / "a.json", tmp_path / "b.json"
    f1.write_text(json.dumps({k: e1.tolist() for k, (e1, _) in tables.items()}))
    f2.write_text(json.dumps({k: e2.tolist() for k, (_, e2) in tables.items()}))
    return f"{f1},{f2}"


def test_avg_diff_file_equals_jax(tmp_path):
    pair = _write_pair(tmp_path, {"m": _sets("separable", 0), "ViT-B/32": _sets("overlapping", 1)})
    V.main(["--avg-diff", pair, "--outfile", str(tmp_path / "port.json")])
    JV.main(["--avg-diff", pair, "--outfile", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("kind", ["separable", "overlapping"])
@pytest.mark.parametrize("seed", [0, 3, 4])
def test_svm_normal_solves_liblinears_problem(kind, seed):
    e1, e2 = _sets(kind, seed)
    X = np.concatenate([e1, e2])
    y = np.concatenate([np.zeros(len(e1)), np.ones(len(e2))])
    want = svm.LinearSVC(C=1.0, tol=1e-10, max_iter=1_000_000).fit(X, y).coef_[0]
    got = V.svm_normal(X, y)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


SVM_TOL = {"separable": (5e-2, 5e-4), "overlapping": (2e-3, 1e-6)}  # (of max|v|, 1 − cosine)


@pytest.mark.parametrize("kind", ["separable", "overlapping"])
@pytest.mark.parametrize("seed", range(10))
def test_svm_diff_within_liblinears_tolerance_of_jax(tmp_path, kind, seed):
    pair = _write_pair(tmp_path, {"m": _sets(kind, seed)})
    gap, cos_gap = SVM_TOL[kind]
    V.main(["--svm-diff", pair, "--outfile", str(tmp_path / "port.json")])
    JV.main(["--svm-diff", pair, "--outfile", str(tmp_path / "jax.json")])
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert port.keys() == ref.keys()
    for k in ref:
        got, want = np.array(port[k]), np.array(ref[k])
        assert got.shape == want.shape == (1, len(want[0]))
        assert np.abs(got - want).max() <= gap * np.abs(want).max()
        cos = float(got[0] @ want[0] / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 1 - cos_gap


def test_spew_vectors_matches_jax(tmp_path, monkeypatch):
    for i, shape in enumerate(((40, 40, 3), (30, 50, 3), (64, 33, 3))):
        arr = np.random.default_rng(i).integers(0, 256, shape, dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    jax_tiny = JPerceptor("TinyTest", dtype=np.float32)
    sd = state_dict_from_flax(jax_tiny.variables["params"], jax_tiny.config)
    monkeypatch.setitem(JV._perceptors, "TinyTest", jax_tiny)
    monkeypatch.setitem(V._perceptors, "TinyTest", Perceptor("TinyTest", "cpu", torch.float32, state_dict=sd))
    for module, out in ((V, "port.json"), (JV, "jax.json")):
        args = SimpleNamespace(models=["TinyTest"], limit=None)
        module.spew_vectors(args, str(tmp_path / "img*.png"), str(tmp_path / out))
    got = np.array(json.loads((tmp_path / "port.json").read_text())["TinyTest"])
    want = np.array(json.loads((tmp_path / "jax.json").read_text())["TinyTest"])
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_init_builds_the_named_towers(monkeypatch):
    """``init`` on the CPU: f32 towers of the named models; on the card, bf16 (``chip_smoke.py``)."""
    monkeypatch.setattr(V, "_perceptors", {})
    args = SimpleNamespace(models="TinyTest, TinyTest48", device="cpu")
    V.init(args)
    assert args.models == ["TinyTest", "TinyTest48"]
    assert [(p.name, p.dtype, p.device.type) for p in V._perceptors.values()] == [
        ("TinyTest", torch.float32, "cpu"), ("TinyTest48", torch.float32, "cpu")]
