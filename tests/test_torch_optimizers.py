"""The port's optimizer suite against the JAX package's ``build_optimizer``
(optax under ``inject_hyperparams``) on the CPU.

Each of the six optimizers takes 5 steps from one seeded dict of leaves (a
matrix, a matrix of ones whose gradients have as many positive as negative
entries, so that AdamP projects it, and a scalar, which AdamP leaves as it
is) with the same seeded gradients: the updates, the parameters and every
state leaf (``jax_leaves`` against optax's leaves, in order) within 1e-6.
Then ``set_learning_rate`` against JAX's, and ``reset`` against ``init``:
Adagrad's accumulator goes back to 0.1, not 0, and every tensor keeps its
address (a captured block reads them there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixray_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from pixray_tpu.engine.optimizers import set_learning_rate as j_set_learning_rate
from pixray_tpu_torch.engine.optimizers import OPTIMIZERS, build_optimizer, set_learning_rate, state_tensors

NAMES = ["Adam", "AdamW", "Adagrad", "Adamax", "DiffGrad", "AdamP"]
LR = 0.05
STEPS = 5


def _params(rng):
    return {"a": rng.standard_normal((6, 8)).astype(np.float32),
            "b": np.ones((10, 10), np.float32),
            "c": np.float32(rng.standard_normal())}


def _grads(rng):
    balanced = rng.permutation(np.repeat([1.0, -1.0], 50)) * rng.uniform(0.5, 1.5, 100)
    return {"a": rng.standard_normal((6, 8)).astype(np.float32),
            "b": balanced.reshape(10, 10).astype(np.float32),
            "c": np.float32(rng.standard_normal())}


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _assert_state(port_opt, state, j_state, atol=1e-6):
    got = port_opt.jax_leaves(state)
    want = jax.tree_util.tree_leaves(j_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w) and g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    j_opt, opt = j_build_optimizer(name, LR), build_optimizer(name, LR)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _torch(p0)
    j_state, state = j_opt.init(jp), opt.init(tp)
    _assert_state(opt, state, j_state, atol=0)
    addresses = [t.data_ptr() for t in state_tensors(state)]
    for step in range(STEPS):
        g = _grads(rng)
        j_updates, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, jp)
        updates, _ = opt.update(_torch(g), state, tp)
        for k in p0:
            np.testing.assert_allclose(updates[k].numpy(), np.asarray(j_updates[k]), atol=1e-6, err_msg=k)
        if name == "AdamP" and step == 0:  # the balanced leaf's step is projected off the ones
            radial = float((updates["b"] * tp["b"]).sum())
            assert abs(radial) < 1e-6 * float(updates["b"].abs().sum())
        jp = optax.apply_updates(jp, j_updates)
        tp = {k: tp[k] + updates[k] for k in tp}
        _assert_state(opt, state, j_state)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
    assert [t.data_ptr() for t in state_tensors(state)] == addresses  # updated in place


@pytest.mark.parametrize("name", NAMES)
def test_set_learning_rate_and_reset(name):
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    j_opt, opt = j_build_optimizer(name, LR), build_optimizer(name, LR)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _torch(p0)
    j_state, state = j_opt.init(jp), opt.init(tp)
    for _ in range(2):
        g = _grads(rng)
        _, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, jp)
        opt.update(_torch(g), state, tp)
    j_state = j_set_learning_rate(j_state, 0.25)
    assert set_learning_rate(state, 0.25) is state
    _assert_state(opt, state, j_state)
    addresses = [t.data_ptr() for t in state_tensors(state)]
    opt.reset(state)
    _assert_state(opt, state, j_opt.init(jp), atol=0)
    assert [t.data_ptr() for t in state_tensors(state)] == addresses
    if name == "Adagrad":
        assert all(bool((t == np.float32(0.1)).all()) for t in state.sum_of_squares.values())


def test_unknown_optimizer_raises_like_jax():
    assert sorted(OPTIMIZERS) == sorted(NAMES)
    with pytest.raises(ValueError, match="Unknown optimiser: SGD"):
        build_optimizer("SGD", LR)
    with pytest.raises(ValueError, match="Unknown optimiser: SGD"):
        j_build_optimizer("SGD", LR).init({"a": jnp.zeros(2)})
