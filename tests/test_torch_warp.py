"""The port's cutout-bank warp on the CPU — the plain twin of the CUDA
kernels K1/K2, reached through the same dispatching wrapper the engine
calls — against the JAX package's Pallas warp, run in interpret mode.

Inputs come from a numpy seed: a 20x28x3 canvas and banks of perspective
cuts with ragged N (5) and ragged S (17).

Tolerances:
- exact rung (``precision="highest"``): forward 1e-4, gradient w.r.t. the
  canvas 1e-3 — the ones tests/test_pallas_warp.py pins for this rung (f32
  hat sums vs 4-tap sums round differently);
- int8 forward rung (the JAX default): 2e-2 on [0, 1] canvases — the
  kernel's own comment puts its quantization error near 9e-3.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops.pallas_warp import pallas_warp_batch_modes
from pixray_tpu.ops.warp_batch import warp_batch_separable as jax_separable
from pixray_tpu_torch.ops import cuda_warp
from pixray_tpu_torch.ops import warp as W
from pixray_tpu_torch.ops.warp_batch import warp_batch_separable

H, W_, S, N = 20, 28, 17, 5
FILL = 0.4


def _canvas():
    return np.random.default_rng(0).random((H, W_, 3)).astype(np.float32)


def _perspective_bank(n=N, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    persp = W.random_perspective(H, W_, 0.3, t(rng.random((n, 4, 2))))
    crop = W.random_resized_crop(H, W_, S, t(rng.uniform(0.3, 0.9, n)),
                                 t(rng.uniform(np.log(0.85), np.log(1.2), n)),
                                 t(rng.random(n)), t(rng.random(n)))
    return W.mm3(crop, persp).numpy()


# per case: (modes, fill mask) over the N-cut bank
CASES = {
    "reflection": ([0] * N, [False] * N),
    "border": ([1] * N, [False] * N),
    "zeros": ([2] * N, [False] * N),
    "fill": ([2] * N, [True] * N),
    "mixed": ([0, 1, 2, 2, 1], [False, False, False, True, False]),
}


@lru_cache(maxsize=None)
def _jax_fn(precision):
    def f(work, ms, modes, fill_mask):
        return pallas_warp_batch_modes(work, ms, modes, S, fill_value=FILL, fill_mask=fill_mask,
                                       interpret=True, precision=precision, out_layout="nchw")
    return jax.jit(f)


@lru_cache(maxsize=None)
def _jax_result(case, precision="highest"):
    modes, mask = CASES[case]
    args = (jnp.asarray(_perspective_bank()), jnp.asarray(modes, jnp.int32), jnp.asarray(mask))
    work = jnp.asarray(_canvas())
    out, vjp = jax.vjp(lambda w: _jax_fn(precision)(w, *args), work)
    cot = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    (grad,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(grad), cot


def _port(case):
    modes, mask = CASES[case]
    work = torch.tensor(_canvas(), requires_grad=True)
    out = cuda_warp.warp_batch_modes(work, torch.tensor(_perspective_bank()), torch.tensor(modes),
                                     S, fill_value=FILL, fill_mask=torch.tensor(mask))
    return work, out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_exact(case):
    ref, _, _ = _jax_result(case)
    _, out = _port(case)
    assert out.shape == (N, 3, S, S)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_grad_matches_jax_exact(case):
    _, ref_grad, cot = _jax_result(case)
    work, out = _port(case)
    (grad,) = torch.autograd.grad(out, work, torch.tensor(cot))
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-3)


@pytest.mark.parametrize("case", ["border", "fill", "mixed"])
def test_forward_matches_jax_int8_rung(case):
    ref, _, _ = _jax_result(case, "int8")
    _, out = _port(case)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-2)


def test_cpu_tensors_launch_no_kernel():
    cuda_warp.reset_launch_counts()
    work, out = _port("mixed")
    torch.autograd.grad(out.sum(), work)
    assert {"warp_fwd", "warp_bwd"} <= set(cuda_warp.LAUNCHES) and set(cuda_warp.LAUNCHES.values()) == {0}


def test_cuda_wrapper_refuses_other_devices():
    work = torch.empty((H, W_, 3), device="meta")
    inv = torch.eye(3).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError):
        cuda_warp.warp_modes(work, inv, torch.zeros(2, dtype=torch.int32), 0.0, S)
    with pytest.raises(ValueError):  # the launcher itself takes only CUDA tensors
        cuda_warp.launch_fwd(torch.zeros((H, W_, 3)), inv, torch.zeros(2, dtype=torch.int32), 0.0, S)


@pytest.mark.parametrize("fill", [False, True])
def test_separable_matches_jax(fill):
    """Axis-aligned cuts: the two-matmul warp, forward and gradient (f32;
    the JAX package runs these matmuls in f32 on the CPU too)."""
    rng = np.random.default_rng(3)
    n = 4
    x0, y0 = rng.uniform(-4, 10, n), rng.uniform(-4, 8, n)
    cw, ch = rng.uniform(8, 30, n), rng.uniform(8, 22, n)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    ms = W.crop_box_transform(t(x0), t(y0), t(cw), t(ch), S, S).numpy()
    modes = np.array([0, 1, 2, 2], np.int32)
    mask = np.array([False, False, fill, True]) if fill else None
    cot = rng.standard_normal((n, 3, S, S)).astype(np.float32)

    def jax_f(w):
        return jax_separable(w, jnp.asarray(ms), jnp.asarray(modes), S, fill_value=FILL,
                             fill_mask=None if mask is None else jnp.asarray(mask), out_layout="nchw")

    ref, vjp = jax.vjp(jax_f, jnp.asarray(_canvas()))
    (ref_grad,) = vjp(jnp.asarray(cot))
    work = torch.tensor(_canvas(), requires_grad=True)
    out = warp_batch_separable(work, torch.tensor(ms), torch.tensor(modes), S, fill_value=FILL,
                               fill_mask=None if mask is None else torch.tensor(mask))
    (grad,) = torch.autograd.grad(out, work, torch.tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-4)
