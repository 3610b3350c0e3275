"""The port's single-mode bank warp ``cuda_warp.warp_batch`` on the CPU (the
plain twin of K1/K2 as the bare warp, through the wrapper the card runs)
against the JAX package's ``pallas_warp_batch`` in interpret mode at its
exact rung (``precision="highest"``), one case per padding mode.

The cases are ``pixray_tpu/tools/crosscheck.py``'s (8 cuts, each a random
resized crop of a random perspective from ``fold_in(PRNGKey(0), i)``, fill
0.5, a seeded cotangent), on a 24x64x3 canvas with 16-pixel cuts in place
of its 224x597x3 canvas and 224-pixel cuts, so that interpret mode runs in
seconds.  Tolerances are test_torch_warp.py's for this rung: forward 1e-4,
the canvas gradient 1e-3 (reflection and fill, as crosscheck checks them).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops import warp as JW
from pixray_tpu.ops.pallas_warp import pallas_warp_batch
from pixray_tpu_torch.ops import cuda_warp

H, W, S, N, FILL = 24, 64, 16, 8, 0.5


@lru_cache(maxsize=None)
def _case():
    rng = np.random.default_rng(0)
    work = rng.random((H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ms = []
    for i in range(N):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        ms.append(JW.random_resized_crop(k2, H, W, S) @ JW.random_perspective(k1, H, W, 0.4))
    g_out = rng.random((N, S, S, 3)).astype(np.float32)
    return work, np.asarray(jnp.stack(ms)), g_out


@lru_cache(maxsize=None)
def _jax(mode):
    work, ms, g_out = _case()
    fn = lambda w: pallas_warp_batch(w, jnp.asarray(ms), S, mode, FILL, interpret=True, precision="highest")
    out, vjp = jax.vjp(fn, jnp.asarray(work))
    (grad,) = vjp(jnp.asarray(g_out))
    return np.asarray(out), np.asarray(grad)


def _port(mode):
    work, ms, g_out = _case()
    w = torch.tensor(work, requires_grad=True)
    out = cuda_warp.warp_batch(w, torch.tensor(ms), S, mode, FILL)
    (grad,) = torch.autograd.grad(out, w, torch.tensor(g_out).permute(0, 3, 1, 2))
    return out.detach().permute(0, 2, 3, 1).numpy(), grad.numpy()


@pytest.mark.parametrize("mode", ["reflection", "border", "fill", "zeros"])
def test_warp_batch_forward_matches_pallas(mode):
    ref, _ = _jax(mode)
    out, _ = _port(mode)
    assert out.shape == ref.shape == (N, S, S, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("mode", ["reflection", "fill"])
def test_warp_batch_gradient_matches_pallas(mode):
    _, ref = _jax(mode)
    _, grad = _port(mode)
    np.testing.assert_allclose(grad, ref, atol=1e-3)


def test_warp_batch_modes_and_dispatch():
    work, ms, _ = _case()
    cuda_warp.reset_launch_counts()
    out = cuda_warp.warp_batch(torch.tensor(work), torch.tensor(ms), S, "border")
    assert cuda_warp.LAUNCHES == {"warp_fwd": 0, "warp_bwd": 0}  # CPU tensors: the plain version
    same = cuda_warp.warp_batch_modes(torch.tensor(work), torch.tensor(ms), torch.ones(N, dtype=torch.int32), S)
    assert torch.equal(out, same)
    with pytest.raises(ValueError):
        cuda_warp.warp_batch(torch.tensor(work), torch.tensor(ms), S, "wrap")
    with pytest.raises(ValueError):
        cuda_warp.warp_batch(torch.empty((H, W, 3), device="meta"), torch.tensor(ms), S, "zeros")
