"""The port's ensemble math (``pixray_tpu_torch/parallel/ensemble.py``)
against the JAX package's, in one process: ``pad_table``,
``_partial_prompt_losses`` (values and gradients), ``_partial_pair_loss``
and ``ensemble_active``; and the chunk shares of the prompt losses summed
against the port's ``prompt_losses`` over the whole bank.  Prompt tables
carry weights of both signs and finite and -inf stops.  Tolerance 1e-6
(f32, the same operations in the same order up to the matmul's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixray_tpu.engine.prompts import PromptTable as JPromptTable
from pixray_tpu.parallel import ensemble as J
from pixray_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pixray_tpu_torch.engine.prompts import PromptTable, prompt_losses
from pixray_tpu_torch.parallel import ensemble as E
from pixray_tpu_torch.parallel.mesh import Mesh as PMesh

ATOL = 1e-6


def _rows(rng, n, d):
    """Rows of both signs, with finite stops (some binding) and -inf ones."""
    weights = [1.0, -0.5, 2.0, -1.5, 0.25][:n]
    stops = [float("-inf"), 0.4, -0.9, float("-inf"), 0.2][:n]
    return [(rng.standard_normal(d).astype(np.float32), w, s) for w, s in zip(weights, stops)]


def _tables(rows, d):
    return PromptTable.from_rows(rows, d), JPromptTable.from_rows(rows) if rows else JPromptTable.empty(d)


@pytest.mark.parametrize("n, d, l_max, d_max", [(3, 32, 5, 48), (5, 48, 5, 48), (0, 32, 2, 32)])
def test_pad_table_matches_jax(n, d, l_max, d_max):
    port, ref = _tables(_rows(np.random.default_rng(n), n, d), d)
    for got, want in zip(E.pad_table(port, l_max, d_max), J.pad_table(ref, l_max, d_max)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk, d, d_max, n_total", [(4, 32, 32, 8), (3, 32, 48, 12), (16, 48, 48, 64)])
def test_partial_prompt_losses_match_jax(chunk, d, d_max, n_total):
    rng = np.random.default_rng(chunk)
    emb = rng.standard_normal((chunk, d)).astype(np.float32)
    e, w, s = J.pad_table(JPromptTable.from_rows(_rows(rng, 5, d)), 5, d_max)
    ref_fn = lambda x: J._partial_prompt_losses(x, jnp.asarray(e), jnp.asarray(w), jnp.asarray(s), n_total)
    ref, vjp = jax.vjp(ref_fn, jnp.asarray(emb))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    (ref_g,) = vjp(jnp.asarray(cot))
    x = torch.tensor(emb, requires_grad=True)
    got = E._partial_prompt_losses(x, torch.tensor(e), torch.tensor(w), torch.tensor(s), n_total)
    (g,) = torch.autograd.grad(got, x, torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=ATOL)


@pytest.mark.parametrize("weight", [0.8, -0.6, 0.0])
def test_partial_pair_loss_matches_jax(weight):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    e_all = rng.standard_normal((8, 24)).astype(np.float32)
    ref = J._partial_pair_loss(jnp.asarray(x), jnp.asarray(e_all), weight, 8)
    got = E._partial_pair_loss(torch.tensor(x), torch.tensor(e_all), weight, 8)
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunk_shares_sum_to_prompt_losses(n_chunks):
    rng = np.random.default_rng(n_chunks)
    bank = torch.tensor(rng.standard_normal((16, 32)).astype(np.float32))
    table = PromptTable.from_rows(_rows(rng, 5, 32), 32)
    c = 16 // n_chunks
    shares = sum(E._partial_prompt_losses(bank[i * c:(i + 1) * c], table.embeds, table.weights, table.stops, 16)
                 for i in range(n_chunks))
    np.testing.assert_allclose(shares.numpy(), prompt_losses(bank, table).numpy(), atol=ATOL)


def _port_mesh(d, m):
    return PMesh({DATA_AXIS: d, MODEL_AXIS: m}, 0, 0, 0, None, None, None)


@pytest.mark.parametrize("d, m", [(2, 2), (4, 1), (1, 2), (2, 4)])
@pytest.mark.parametrize("n_perceptors", [1, 2, 3])
def test_ensemble_active_matches_jax(d, m, n_perceptors):
    ref_mesh = Mesh(np.asarray(jax.devices("cpu")[:d * m]).reshape(d, m), (DATA_AXIS, MODEL_AXIS))
    assert E.ensemble_active(_port_mesh(d, m), n_perceptors) == J.ensemble_active(ref_mesh, n_perceptors)
    assert E.ensemble_active(None, n_perceptors) == J.ensemble_active(None, n_perceptors) is False


def test_members_placed_round_robin():
    """Member p on model index p % M: 3 members on 2 groups put two on group 0."""
    mesh = _port_mesh(2, 2)
    assert [E.owner(p, mesh) for p in range(3)] == [0, 1, 0]
