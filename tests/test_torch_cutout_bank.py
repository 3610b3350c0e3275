"""The cutout bank on the CPU: the plain twin of the CUDA kernels K1/K2
(``ops/cuda_warp.py``), the jitter adjoint K2 evaluates, and the packed
per-cut parameters, against autograd and the JAX package.

Tolerances:
- jitter adjoint vs autograd of ``jitter_planes``: 1e-5 relative to the
  largest gradient (the two sum the same terms in another order), and
  exact where autograd's tie rules give zero or halve;
- plain bank vs JAX ``render_cutouts(layout="nchw")``, f32: forward 2e-5
  and gradient 1e-4 of max|dwork| (the axis-aligned cuts are a 4-tap
  gather here and two hat matmuls in JAX: f32 sums in another order, which
  the HSV round trip's divisions by the channel spread magnify; measured
  5.6e-6 and 4.7e-6);
- bf16: forward one bf16 ulp at the top of the bank's range (2**-7 for
  values below 2: an f32 value that rounds to the other side of a bf16
  midpoint), and the gradient to 1e-3 of max|dwork| (a cotangent the
  jitter's ``.float()`` backward rounds to bf16 one ulp apart, 2**-8
  relative, on a few elements); measured 0 and 4.1e-6.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.engine import cutouts as JC
from pixray_tpu.ops.color import _draw_jitter_params
from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.ops import cuda_warp
from pixray_tpu_torch.ops.color import jitter_planes, jitter_planes_adjoint

S, CUTN, ASPECT, FILL = 24, 10, 96 / 54, 0.43


# ------------------------------------------------------------------ jitter adjoint
def _tie_planes():
    """(3, N, H, W) planes built to tie: gray pixels, values at 0 and 1, two-
    and three-way maxima and minima, hue on sector boundaries, s·factor at 1."""
    rng = np.random.default_rng(11)
    n, h, w = 6, 8, 12
    r, g, b = rng.uniform(-0.1, 1.1, (3, n, h, w)).astype(np.float32)
    r[:, 0], g[:, 0], b[:, 0] = 0.5, 0.5, 0.5            # gray
    r[:, 1, :4], g[:, 1, :4], b[:, 1, :4] = 0.0, 0.0, 0.0  # dark, at the lower bound
    r[:, 1, 4:], g[:, 1, 4:], b[:, 1, 4:] = 1.0, 1.0, 1.0  # white, at the upper bound
    g[:, 2] = r[:, 2]                                     # r == g (max or min)
    b[:, 3] = r[:, 3]                                     # r == b
    b[:, 4] = g[:, 4]                                     # g == b: hue on a sector boundary
    r[:, 5, :6], g[:, 5, :6], b[:, 5, :6] = 0.8, 0.0, 0.0  # s == 1 (minc == 0), pure red
    r[:, 5, 6:], g[:, 5, 6:], b[:, 5, 6:] = 0.6, 0.6, 0.0  # s == 1, two-way max, hue 1/6
    r[:, 6, ::2] = 1.0                                    # at the clip bound, not gray
    g[:, 7, ::3] = 0.0
    hue = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    hue[0], hue[1] = 0.0, 0.5                             # keep boundary hues on the boundary
    sat = rng.uniform(0.9, 1.1, n).astype(np.float32)
    sat[0] = sat[2] = 1.0                                 # s * factor exactly 1 on the s == 1 pixels
    return np.stack([r, g, b]), hue, sat


@pytest.mark.parametrize("rounded", [False, True], ids=["f32", "bf16_inputs"])
def test_jitter_adjoint_matches_autograd(rounded):
    planes, hue, sat = _tie_planes()
    x = torch.tensor(planes)
    if rounded:
        x = x.bfloat16().float()
    hs = torch.tensor(hue)[:, None, None]
    sf = torch.tensor(sat)[:, None, None]
    rng = np.random.default_rng(12)
    cots = [torch.tensor(rng.standard_normal(planes.shape[1:]).astype(np.float32)) for _ in range(3)]
    leaves = [p.clone().requires_grad_(True) for p in x]
    ref = torch.autograd.grad(jitter_planes(*leaves, hs, sf), leaves, cots)
    got = jitter_planes_adjoint(*x, hs, sf, *cots)
    scale = max(float(t.abs().max()) for t in ref)
    ties = np.zeros(planes.shape[1:], bool)
    ties[:, :8] = True
    for a, e in zip(got, ref):
        a, e = a.numpy(), e.numpy()
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-5 * scale)
        # the tie rules: zero exactly where autograd gives zero (the halves
        # are held by the tolerance above and exactly in the test below)
        np.testing.assert_array_equal(a[ties] == 0, e[ties] == 0)


def test_jitter_adjoint_splits_ties_in_halves():
    """One pixel per rule, against hand-derived values."""
    one = torch.ones(1)
    zero = torch.zeros(1)
    # gray, at no bound: hue and saturation carry nothing, v takes it all and
    # the three-way max splits it 1/4, 1/4, 1/2 (maximum(maximum(r, g), b))
    got = jitter_planes_adjoint(0.5 * one, 0.5 * one, 0.5 * one, zero, one, one, zero, zero)
    assert [float(t) for t in got] == [0.25, 0.25, 0.5]
    # white at the clip bound: the same split, halved again by the clip
    got = jitter_planes_adjoint(one, one, one, zero, one, one, zero, zero)
    assert [float(t) for t in got] == [0.125, 0.125, 0.25]


# ------------------------------------------------------------------ bank vs JAX
def _work():
    return np.random.default_rng(21).random((S, S, 3)).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_bank(dtype_name, reflect):
    """JAX render_cutouts (nchw) with its own draws, its gradient to work,
    and those draws as torch tensors for the port."""
    dtype = None if dtype_name == "f32" else jnp.bfloat16
    key = jax.random.PRNGKey(4)
    k_t, k_jit, k_noise = jax.random.split(key, 3)
    zoom, wide = JC.sample_cut_transforms(k_t, S, CUTN, ASPECT)

    def f(w):
        return JC.render_cutouts(w, (zoom, wide), S, reflect_padding=reflect, fill_color=FILL,
                                 noise_key=k_noise, jitter_key=k_jit, compute_dtype=dtype, layout="nchw")

    out, vjp = jax.vjp(f, jnp.asarray(_work()))
    cot = jnp.asarray(np.random.default_rng(22).standard_normal(out.shape).astype(np.float32), out.dtype)
    (grad,) = vjp(cot)
    # the draws render_cutouts makes inside, made again
    hs, sf, ap = jax.vmap(lambda k: _draw_jitter_params(k, 0.1, 0.1, 0.8))(jax.random.split(k_jit, CUTN))
    bank_dtype = dtype or jnp.float32
    k_fac, k_planes = jax.random.split(k_noise)
    facs = jax.random.uniform(k_fac, (CUTN, 1, 1), maxval=JC.NOISE_FAC, dtype=bank_dtype)
    planes = [jax.random.normal(kp, (CUTN, S, S), dtype=bank_dtype) for kp in jax.random.split(k_planes, 3)]
    tdt = torch.float32 if dtype is None else torch.bfloat16

    def t(a, to=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(to)

    draws = {"transforms": (t(zoom), t(wide)), "jitter": (t(hs), t(sf), torch.tensor(np.asarray(ap))),
             "noise": (t(facs, tdt), [t(p, tdt) for p in planes])}
    return (np.asarray(out.astype(jnp.float32)), np.asarray(grad), t(cot, tdt), draws)


def _port_bank(dtype_name, reflect, draws):
    dtype = None if dtype_name == "f32" else torch.bfloat16
    work = torch.tensor(_work(), requires_grad=True)
    out = C.render_cutouts(work, draws["transforms"], S, reflect_padding=reflect, fill_color=FILL,
                           jitter=draws["jitter"], noise=draws["noise"], compute_dtype=dtype)
    return work, out


@pytest.mark.parametrize("reflect", [True, False], ids=["reflection", "border"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_plain_bank_matches_jax_render_cutouts(dtype_name, reflect):
    ref, ref_grad, cot, draws = _jax_bank(dtype_name, reflect)
    work, out = _port_bank(dtype_name, reflect, draws)
    assert out.shape == (CUTN, 3, S, S)
    assert out.dtype == (torch.float32 if dtype_name == "f32" else torch.bfloat16)
    (grad,) = torch.autograd.grad(out, work, cot)
    out, grad = out.detach().float().numpy(), grad.numpy()
    scale = float(np.abs(ref_grad).max())
    if dtype_name == "f32":
        np.testing.assert_allclose(out, ref, atol=2e-5)
        np.testing.assert_allclose(grad, ref_grad, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0 ** -7)
        np.testing.assert_allclose(grad, ref_grad, atol=1e-3 * scale)


# ------------------------------------------------------------------ dispatch, parameters
def _bank_inputs(dtype):
    draws = _jax_bank("f32" if dtype is None else "bf16", True)[3]
    zoom, wide = draws["transforms"]
    ms = torch.cat([zoom, wide])[C.bank_order(zoom.shape[0], wide.shape[0])]
    modes = torch.tensor([0] * 6 + [3] * 4)[C.bank_order(6, 4)]
    facs, planes = draws["noise"]
    params = cuda_warp.pack_params(C.W.inv3x3(ms), modes, draws["jitter"], facs, fill=FILL)
    return params, planes


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_bank_launches_no_kernel_and_is_the_plain_version(dtype):
    params, planes = _bank_inputs(dtype)
    cuda_warp.reset_launch_counts()
    work = torch.tensor(_work(), requires_grad=True)
    out = cuda_warp.cutout_bank(work, params, S, planes, dtype)
    (grad,) = torch.autograd.grad(out.float().sum(), work)
    assert {"warp_fwd", "warp_bwd"} <= set(cuda_warp.LAUNCHES) and set(cuda_warp.LAUNCHES.values()) == {0}
    work_p = torch.tensor(_work(), requires_grad=True)
    plain = cuda_warp.cutout_bank_plain(work_p, params, S, planes, dtype)
    (grad_p,) = torch.autograd.grad(plain.float().sum(), work_p)
    assert torch.equal(out, plain)
    assert torch.equal(grad, grad_p)


def test_bank_refuses_other_devices():
    params, planes = _bank_inputs(None)
    with pytest.raises(ValueError):
        cuda_warp.cutout_bank(torch.empty((S, S, 3), device="meta"), params, S)
    with pytest.raises(ValueError):  # the launchers take only CUDA tensors
        cuda_warp.launch_bank_fwd(torch.zeros((S, S, 3)), params, S, planes)
    with pytest.raises(ValueError):
        cuda_warp.launch_bank_bwd(torch.zeros((CUTN, 3, S, S)), None, params, (S, S, 3), S)


def test_packed_parameters_round_trip():
    rng = np.random.default_rng(31)
    n = 7
    inv = torch.tensor(rng.standard_normal((n, 3, 3)).astype(np.float32))
    modes = torch.tensor([0, 1, 2, 3, 3, 1, 0], dtype=torch.int32)
    hue = torch.tensor(rng.uniform(-0.1, 0.1, n).astype(np.float32))
    sat = torch.tensor(rng.uniform(0.9, 1.1, n).astype(np.float32))
    apply = torch.tensor([True, False, True, True, False, True, False])
    facs = torch.tensor(rng.uniform(0, 0.1, (n, 1, 1)).astype(np.float32)).bfloat16()
    params = cuda_warp.pack_params(inv, modes, (hue, sat, apply), facs, fill=0.37)
    assert params.shape == (n, cuda_warp.PARAM_STRIDE) and params.dtype == torch.float32
    back = cuda_warp.unpack_params(params)
    assert torch.equal(back["inv"], inv)
    assert torch.equal(back["modes"], modes)
    assert torch.equal(back["hue"], hue) and torch.equal(back["sat"], sat)
    assert torch.equal(back["apply"], apply)
    assert torch.equal(back["facs"].bfloat16(), facs.reshape(n))  # bf16 values travel exactly
    bare = cuda_warp.unpack_params(cuda_warp.pack_params(inv, modes))
    assert torch.equal(back["fill"], torch.full((n,), 0.37))
    assert not bool(bare["apply"].any()) and not bool(bare["facs"].any()) and not bool(bare["fill"].any())


def test_bank_order_is_the_jax_bank_order():
    """Rows: zoom-perspective, wide-perspective, zoom-axis-aligned, wide-axis-aligned."""
    nz, nw = C.split_counts(64)
    order = C.bank_order(nz, nw).tolist()
    (zp, _), (wp, _) = C.persp_split(nz), C.persp_split(nw)
    assert order == (list(range(zp)) + list(range(nz, nz + wp)) + list(range(zp, nz))
                     + list(range(nz + wp, nz + nw)))
