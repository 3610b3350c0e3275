"""The port's stroke rasterizer on the CPU — the plain version of the CUDA
kernels K4, K4s and K5, reached through the dispatching wrapper the drawers
call — against the JAX package's XLA path (``render_strokes``); the
comparisons with its fused Pallas kernels (interpret mode, slow to trace)
are in test_torch_strokes_fused.py, apart from the zero-alpha case here.

Inputs come from a numpy seed: the 40x140 / 9-stroke scene of
tests/test_pallas_strokes.py (remainder tiles, padded chunks), its
off-canvas / zero-length scene, and an exact-tie scene.

Tolerances (those of tests/test_pallas_strokes.py): forward atol 1e-4;
gradients rtol 2e-4, atol 2e-5 after dividing by max|reference gradient|
(f32 sums in other orders; the fused kernel's envelope gradient drops the
1e-8 eps term).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops.pallas_strokes import _pack_meta, render_strokes_fused
from pixray_tpu.ops.strokes import bezier_basis as j_bezier_basis
from pixray_tpu.ops.strokes import render_strokes as j_render_strokes
from pixray_tpu_torch.ops import cuda_strokes
from pixray_tpu_torch.ops.strokes import bezier_basis, pack_meta, render_strokes

NAMES = ("points", "widths", "colors", "bg")


def _random_scene(seed, n, max_seg, h, w, spread=10.0):
    rng = np.random.default_rng(seed)
    seg_counts = rng.integers(1, max_seg + 1, n)
    basis = np.asarray(j_bezier_basis(seg_counts, max_seg, samples_per_segment=8))
    v = 1 + 3 * max_seg
    pts = rng.uniform(-spread, [w + spread, h + spread], (n, v, 2)).astype(np.float32)
    widths = rng.uniform(1.0, 8.0, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    bg = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return h, w, basis, (pts, widths, colors, bg)


def _degenerate_scene():
    h, w = 40, 128
    basis = np.asarray(j_bezier_basis([1, 1, 1], 1, samples_per_segment=8))
    pts = np.stack([
        np.full((4, 2), -500.0),                     # far off-canvas
        np.tile(np.array([20.0, 20.0]), (4, 1)),     # zero-length (point)
        np.array([[5, 5], [30, 8], [60, 30], [100, 35]]),
    ]).astype(np.float32)
    widths = np.array([3.0, 5.0, 2.0], np.float32)
    colors = np.array([[1, 0, 0, 0.9], [0, 1, 0, 0.8], [0, 0, 1, 0.7]], np.float32)
    bg = np.full((h, w, 3), 0.5, np.float32)
    return h, w, basis, (pts, widths, colors, bg)


def _tie_scene():
    """Exact ties, built with an identity basis so that the polyline samples
    are exactly the given points (a Bernstein basis rounds each sample
    differently).  MAX_SEGMENTS 3 gives P = 25: two zero-length dots (all
    24 segments tie) and two 1-segment strokes whose 9 samples are followed
    by 16 repeats of the endpoint, as a shorter stroke's degenerate tail."""
    h, w, p = 24, 40, 25
    t = np.linspace(0.0, 1.0, 9)[:, None]
    b = lambda p0, p1, p2, p3: ((1 - t) ** 3 * p0 + 3 * t * (1 - t) ** 2 * p1
                                + 3 * t ** 2 * (1 - t) * p2 + t ** 3 * p3)
    tail = lambda s: np.concatenate([s, np.repeat(s[-1:], p - len(s), 0)])
    pts = np.stack([
        np.tile([12.0, 9.0], (p, 1)),
        tail(b(np.array([4.0, 16.0]), np.array([10.0, 12.0]), np.array([20.0, 20.0]), np.array([28.0, 16.0]))),
        tail(b(np.array([30.0, 2.0]), np.array([31.0, 8.0]), np.array([29.0, 14.0]), np.array([30.0, 20.0]))),
        np.tile([6.5, 5.5], (p, 1)),
    ]).astype(np.float32)
    basis = np.tile(np.eye(p, dtype=np.float32), (4, 1, 1))
    widths = np.array([6.0, 3.0, 2.0, 4.0], np.float32)
    colors = np.array([[0.9, 0.1, 0.2, 0.8], [0.1, 0.7, 0.3, 0.6], [0.2, 0.2, 0.9, 0.9],
                       [0.5, 0.5, 0.1, 0.7]], np.float32)
    bg = np.random.default_rng(5).uniform(0, 1, (h, w, 3)).astype(np.float32)
    return h, w, basis, (pts, widths, colors, bg)


def _zero_alpha_scene():
    """5 one-segment strokes at 40x140, stroke 2 with alpha 0 in the middle of the canvas."""
    h, w, basis, (pts, widths, colors, bg) = _random_scene(3, 5, 1, 40, 140)
    pts[2] = np.linspace([40.0, 10.0], [100.0, 30.0], pts.shape[1])
    colors[2, 3] = 0.0
    return h, w, basis, (pts, widths, colors, bg)


SCENES = {"random": lambda: _random_scene(0, 9, 2, 40, 140), "degenerate": _degenerate_scene,
          "ties": _tie_scene, "zero_alpha": _zero_alpha_scene}


def _probe(h, w):
    return np.cos(np.arange(h * w * 4).reshape(h, w, 4) * 0.01).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_result(scene, ref):
    """(forward, gradients of sum(out * probe)) of the JAX XLA path or the
    fused kernels (interpret mode, chunk 4)."""
    h, w, basis, args = SCENES[scene]()
    if ref == "xla":
        render = lambda p, wd, c, b: j_render_strokes(p, wd, c, jnp.asarray(basis), h, w, b)
    else:  # jitted only for time: the XLA path runs as its own tests run it
        render = jax.jit(lambda p, wd, c, b: render_strokes_fused(p, wd, c, jnp.asarray(basis), h, w, b,
                                                                  interpret=True, chunk=4))
    out, vjp = jax.vjp(render, *map(jnp.asarray, args))
    grads = vjp(jnp.asarray(_probe(h, w)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@lru_cache(maxsize=None)
def _port_result(scene):
    h, w, basis, args = SCENES[scene]()
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = cuda_strokes.render_strokes_auto(ts[0], ts[1], ts[2], torch.tensor(basis), h, w, ts[3])
    grads = torch.autograd.grad(out, ts, torch.tensor(_probe(h, w)))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _assert_grads_close(port, ref):
    for name, a, b in zip(NAMES, ref, port):
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, rtol=2e-4, atol=2e-5,
                                   err_msg=f"gradient mismatch: {name}")


@pytest.mark.parametrize("max_seg,counts,sps", [(3, [1, 2, 3, 3, 1], 8), (8, [8] * 3, 8), (2, [1, 2], 5)])
def test_bezier_basis_matches_jax(max_seg, counts, sps):
    np.testing.assert_array_equal(bezier_basis(counts, max_seg, sps).numpy(),
                                  np.asarray(j_bezier_basis(counts, max_seg, sps)))


@pytest.mark.parametrize("scene", ["random", "degenerate"])
def test_forward_matches_jax(scene):
    out, _ = _port_result(scene)
    expected, _ = _jax_result(scene, "xla")
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, atol=1e-4)


@pytest.mark.parametrize("scene", ["random", "degenerate"])
def test_gradients_match_jax(scene):
    _assert_grads_close(_port_result(scene)[1], _jax_result(scene, "xla")[1])


def test_exact_ties_split_evenly():
    """Tied segments share the gradient evenly (torch.amin, as jnp.min):
    a dot's 24 segment starts get equal shares, and so do a stroke's
    zero-length tail segments; torch.min(dim) would give one segment all."""
    out, grads = _port_result("ties")
    ref_out, ref_grads = _jax_result("ties", "xla")
    np.testing.assert_allclose(out, ref_out, atol=1e-4)
    _assert_grads_close(grads, ref_grads)
    dsamples = grads[0]  # identity basis: point gradients are sample gradients
    for stroke, tied in ((0, slice(0, 24)), (3, slice(0, 24)), (1, slice(9, 24)), (2, slice(9, 24))):
        share = dsamples[stroke, tied]
        assert np.abs(share[0]).sum() > 0
        np.testing.assert_allclose(share, np.broadcast_to(share[:1], share.shape), rtol=1e-6)


def test_zero_alpha_stroke_gradient():
    """A stroke with alpha 0 has a nonzero alpha gradient in the XLA path;
    the fused TPU kernels skip it (0).  The port follows the XLA path."""
    _, xla = _jax_result("zero_alpha", "xla")
    _, fused = _jax_result("zero_alpha", "fused")
    _, port = _port_result("zero_alpha")
    assert abs(xla[2][2, 3]) > 1.0
    assert fused[2][2, 3] == 0.0
    _assert_grads_close(port, xla)
    np.testing.assert_allclose(port[2][2, 3], xla[2][2, 3], rtol=1e-4)


def test_pack_meta_matches_jax():
    _, _, basis, (pts, widths, colors, _) = SCENES["random"]()
    samples = np.einsum("npv,nvd->npd", basis, pts).astype(np.float32)
    ref = _pack_meta(jnp.asarray(samples), jnp.asarray(widths), jnp.asarray(colors))
    meta = pack_meta(torch.tensor(samples), torch.tensor(widths), torch.tensor(colors))
    np.testing.assert_allclose(meta.numpy(), np.asarray(ref), rtol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    cuda_strokes.reset_launch_counts()
    h, w, basis, args = SCENES["degenerate"]()
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = cuda_strokes.render_strokes_auto(ts[0], ts[1], ts[2], torch.tensor(basis), h, w, ts[3])
    torch.autograd.grad(out.sum(), ts)
    with torch.no_grad():
        plain = render_strokes(*[torch.tensor(a) for a in args[:3]], torch.tensor(basis), h, w,
                               torch.tensor(args[3]))
    assert torch.equal(out.detach(), plain)
    assert cuda_strokes.LAUNCHES == {"strokes_fwd": 0, "strokes_fwd_store": 0, "strokes_bwd": 0}


def test_cuda_wrapper_refuses_other_devices():
    pts = torch.empty((2, 4, 2), device="meta")
    with pytest.raises(ValueError):
        cuda_strokes.render_strokes_auto(pts, torch.empty(2, device="meta"), torch.empty((2, 4), device="meta"),
                                         torch.empty((2, 9, 4), device="meta"), 8, 8,
                                         torch.empty((8, 8, 3), device="meta"))
    samples, widths, colors = torch.zeros((2, 9, 2)), torch.ones(2), torch.ones((2, 4))
    with pytest.raises(ValueError):  # the launchers themselves take only CUDA tensors
        cuda_strokes.launch_fwd(samples, widths, colors, torch.zeros((4, 8, 8)), store=True)
    state = cuda_strokes.TileState(torch.zeros((2, 2)), torch.ones((2, 2)), torch.zeros(1, dtype=torch.int32),
                                   torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 1, *cuda_strokes.CANVAS_SLOT)))
    with pytest.raises(ValueError):
        cuda_strokes.launch_bwd(torch.zeros((4, 8, 8)), samples, widths, colors, state)
