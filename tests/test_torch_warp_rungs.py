"""The precision rungs of the port's cutout warp on the CPU — the plain
twins of K1's and K2's rung variants (``ops/warp_batch.py``
``warp_modes_prec``), reached through ``cuda_warp.warp_modes`` as the
engine reaches them — against the JAX package's Pallas warp
(``pallas_warp_modes`` at ``precision=rung``, interpret mode) and its VJP.

Both sides get the same inverse matrices (the port's ``inv3x3``): the int8
and bf16 rungs round the hats, so a one-ulp difference in a coordinate
can move a code (XLA's constant folding of the JAX ``inv3x3`` already
moves some).  N=5 perspective cuts of S=17 on a 20x28x3 canvas, as in
tests/test_torch_warp.py; the int8 backward on a 96x72x3 canvas, the
smallest the JAX banded backward (where its int8 branch lives) runs on.

Tolerances (absolute on [0, 1] canvases; the gradient's relative to its
largest element):
- forward "int8": 1e-5.  The integer sums are exact on both sides; what
  is left is the float32 rounding of the coordinates (the exact rung
  differs by 3.2e-6 here);
- forward "high": 2e-5 (the three bf16 products per tap, float32 sums);
- forward "bf16": 1e-3, under a bf16 ulp of the output (2^-9 at 0.25):
  all but one pixel agree within 2e-6; at one pixel the interpreted
  kernel's value is 4.6e-4 from a dense numpy replica of its own body,
  which the port matches;
- gradients "bf16" (also the int8 forward's, whose backward is bf16) 5e-4,
  "high" 2e-5: float32 sums of per-tap bf16 products in another order;
- gradient "int8": 1e-6.  The port's int64 sum is exact; the JAX kernel
  sums int32 tile partials in float32, exactly while they stay below
  2^24, as here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops import pallas_warp as PW
from pixray_tpu_torch.ops import cuda_warp
from pixray_tpu_torch.ops import warp as W
from pixray_tpu_torch.ops import warp_batch as WB
from pixray_tpu_torch.ops.warp import inv3x3
from test_torch_warp import CASES, FILL, S, _canvas, _perspective_bank

FWD_ATOL = {"int8": 1e-5, "high": 2e-5, "bf16": 1e-3}
BWD_RTOL = {"int8": 5e-4, "high": 2e-5, "bf16": 5e-4}  # int8's gradient is bf16 here (h < 80)
INT8_BWD_RTOL = 1e-6


def _jax(work, inv, modes, fill, prec, out_size=S):
    def f(w):
        return PW.pallas_warp_modes(w, jnp.asarray(inv), jnp.asarray(modes), fill, out_size, True, PW.K_TILE, prec,
                                    PW.N_CHUNK, 0, "nchw")

    out, vjp = jax.vjp(f, jnp.asarray(work))
    cot = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    (grad,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(grad), cot


def _port(work, inv, modes, fill, prec, bwd=None, out_size=S):
    tw = torch.tensor(work, requires_grad=True)
    out = cuda_warp.warp_modes(tw, torch.tensor(inv), torch.tensor(modes), fill, out_size, prec, bwd)
    return out, tw


def _bank(case):
    modes, mask = CASES[case]
    inv = inv3x3(torch.tensor(_perspective_bank())).float().numpy()
    md = WB.modes_with_fill(torch.tensor(modes), torch.tensor(mask)).numpy()
    return inv, md, (FILL if any(mask) else 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("prec", ["int8", "bf16", "high"])
def test_rung_matches_pallas(prec, case):
    inv, md, fill = _bank(case)
    work = _canvas()
    ref, ref_grad, cot = _jax(work, inv, md, jnp.asarray(fill, jnp.float32) if fill else None, prec)
    out, tw = _port(work, inv, md, fill, prec)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=FWD_ATOL[prec])
    (grad,) = torch.autograd.grad(out, tw, torch.tensor(cot))
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=BWD_RTOL[prec] * np.abs(ref_grad).max())
    # the rung is what is computed: it differs from the exact warp
    exact = cuda_warp.warp_modes(torch.tensor(work), torch.tensor(inv), torch.tensor(md), fill, S)
    assert float((exact - out.detach()).abs().max()) > (1e-7 if prec == "high" else 1e-4)


def test_int8_backward_matches_pallas(monkeypatch):
    """K2-int8 (PIXRAY_TPU_WARP_BWD_PREC=int8 with an int8 forward) on a
    canvas tall enough for the JAX banded backward."""
    h, w = 96, 72
    rng = np.random.default_rng(7)
    work = rng.random((h, w, 3)).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    persp = W.random_perspective(h, w, 0.3, t(rng.random((5, 4, 2))))
    crop = W.random_resized_crop(h, w, S, t(rng.uniform(0.3, 0.9, 5)), t(rng.uniform(np.log(0.85), np.log(1.2), 5)),
                                 t(rng.random(5)), t(rng.random(5)))
    inv = inv3x3(W.mm3(crop, persp)).float().numpy()
    md = np.array([0, 1, 2, 3, 3], np.int32)
    monkeypatch.setattr(PW, "WARP_BWD_PREC", "int8")
    ref, ref_grad, cot = _jax(work, inv, md, jnp.asarray(FILL, jnp.float32), "int8")
    assert WB.bwd_prec("int8", "int8", h) == "int8" and WB.bwd_prec("int8", "int8", 79) == "bf16"
    out, tw = _port(work, inv, md, FILL, "int8", WB.bwd_prec("int8", "int8", h))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=FWD_ATOL["int8"])
    (grad,) = torch.autograd.grad(out, tw, torch.tensor(cot))
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=INT8_BWD_RTOL * np.abs(ref_grad).max())
    # and it is not the bf16 backward
    out_b, tw_b = _port(work, inv, md, FILL, "int8", "bf16")
    (grad_b,) = torch.autograd.grad(out_b, tw_b, torch.tensor(cot))
    assert float((grad_b - grad).abs().max()) > 1e-3 * float(grad.abs().max())


def _int8_bank_96x72():
    """test_int8_backward_matches_pallas's bank: 5 cuts of S on a 96x72x3 canvas, one per mode and a second fill."""
    h, w = 96, 72
    rng = np.random.default_rng(7)
    work = rng.random((h, w, 3)).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    persp = W.random_perspective(h, w, 0.3, t(rng.random((5, 4, 2))))
    crop = W.random_resized_crop(h, w, S, t(rng.uniform(0.3, 0.9, 5)), t(rng.uniform(np.log(0.85), np.log(1.2), 5)),
                                 t(rng.random(5)), t(rng.random(5)))
    return work, inv3x3(W.mm3(crop, persp)).float().numpy(), np.array([0, 1, 2, 3, 3], np.int32)


@pytest.mark.parametrize("jittered", [False, True], ids=["warp", "jitter"])
def test_cotangent_max_is_the_jax_int8_scale(monkeypatch, jittered):
    """K2-int8's cotangent pass (plain twin ``bank_cotangent_plain``): its
    s_g is ``_run_bwd_multi_TB``'s max(max|g_flat|, 1e-20)
    (pallas_warp.py:782) for the cotangent the JAX package's VJP hands that
    kernel, on test_int8_backward_matches_pallas's 96x72x3 bank.  Without
    jitter that cotangent is the bank's own, and s_g is bitwise the JAX
    one.  With the JAX package's jitter (``_jitter_planes`` on four of the
    five cuts, f32) behind the warp, it is the jitter's VJP, and the port's
    cotangent bank (the explicit adjoint, from the JAX pre-jitter bank) and
    its s_g agree within 1e-5 of the largest cotangent: autograd and the
    explicit adjoint sum the same terms in another order
    (test_torch_cutout_bank.py); the cuts without jitter keep g bitwise."""
    from pixray_tpu.ops.color import _jitter_planes

    work, inv, md = _int8_bank_96x72()
    n = inv.shape[0]
    hs = np.array([0.05, -0.08, 0.0, 0.1, -0.02], np.float32)
    sf = np.array([1.05, 0.92, 1.0, 1.1, 0.95], np.float32)
    apply = np.array([True, True, False, True, True]) if jittered else np.zeros(n, bool)
    seen = {}
    run_bwd = PW._run_bwd_multi_TB

    def spy(g, *args):
        s_g = jnp.maximum(jnp.max(jnp.abs(PW._g_flat(g, n, S * S, 3, args[-1]))).astype(jnp.float32), 1e-20)
        jax.debug.callback(lambda g_, s_: seen.update(g=np.asarray(g_), s_g=np.asarray(s_)), g, s_g)
        return run_bwd(g, *args)

    monkeypatch.setattr(PW, "WARP_BWD_PREC", "int8")
    monkeypatch.setattr(PW, "_run_bwd_multi_TB", spy)
    warp = lambda w: PW.pallas_warp_modes(w, jnp.asarray(inv), jnp.asarray(md), jnp.asarray(FILL, jnp.float32), S,
                                          True, PW.K_TILE, "int8", PW.N_CHUNK, 0, "nchw")

    def f(w):
        out = warp(w)
        r, g, b = out[:, 0], out[:, 1], out[:, 2]
        jr, jg, jb = _jitter_planes(r, g, b, jnp.asarray(hs)[:, None, None], jnp.asarray(sf)[:, None, None])
        ap = jnp.asarray(apply)[:, None, None]
        return jnp.stack([jnp.where(ap, jr, r), jnp.where(ap, jg, g), jnp.where(ap, jb, b)], axis=1)

    out, vjp = jax.vjp(f, jnp.asarray(work))
    cot = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    vjp(jnp.asarray(cot))
    jax.effects_barrier()
    g_kernel = seen["g"].reshape(n, 3, S, S)
    params = cuda_warp.pack_params(torch.tensor(inv), torch.tensor(md),
                                   (torch.tensor(hs), torch.tensor(sf), torch.tensor(apply)), fill=FILL)
    pre = torch.tensor(np.asarray(warp(jnp.asarray(work)))) if jittered else None
    got, s_g = cuda_warp.bank_cotangent_plain(torch.tensor(cot), pre, params)
    assert got.dtype == torch.float32 and s_g.dtype == torch.float32 and s_g.dim() == 0
    np.testing.assert_array_equal(got.numpy()[~apply], cot[~apply])
    np.testing.assert_array_equal(g_kernel[~apply], cot[~apply])
    if jittered:
        scale = float(np.abs(g_kernel).max())
        np.testing.assert_allclose(got.numpy(), g_kernel, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(float(s_g), float(seen["s_g"]), rtol=1e-5)
        assert float(np.abs(g_kernel[apply] - cot[apply]).max()) > 1e-2 * scale  # the jitter's VJP moved it
    else:
        np.testing.assert_array_equal(g_kernel, cot)
        assert float(s_g) == float(seen["s_g"])


def test_int8_backward_is_order_free():
    """The int64 sum: the same gradient bitwise whatever the order of the
    cuts, and equal to a float64 sum of the same integer products."""
    inv, md, fill = _bank("mixed")
    work = _canvas()
    g = torch.randn((5, 3, S, S), generator=torch.Generator().manual_seed(3))
    a = WB.warp_adjoint_rung(g, torch.tensor(inv), torch.tensor(md), work.shape, S, "int8")
    perm = torch.tensor([3, 1, 4, 0, 2])
    b = WB.warp_adjoint_rung(g[perm], torch.tensor(inv)[perm], torch.tensor(md)[perm], work.shape, S, "int8")
    assert torch.equal(a, b)


def test_canvas_quantization_and_single_mode_rungs():
    """quantize_canvas as the JAX int8 forward quantizes (round(work / s_w * 127),
    s_w = max(max|work|, 1e-6)); warp_batch (K3e/K3f) runs int8 as bf16."""
    work = _canvas()
    q, s_w = WB.quantize_canvas(torch.tensor(work))
    js = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(work))), 1e-6)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jnp.round(jnp.asarray(work) / js * 127.0).astype(jnp.int8)))
    assert float(s_w) == float(js)
    assert float(WB.quantize_canvas(torch.zeros((2, 2, 3)))[1]) == np.float32(1e-6)
    ms = torch.tensor(_perspective_bank())
    a = cuda_warp.warp_batch(torch.tensor(work), ms, S, "reflection", precision="int8")
    b = cuda_warp.warp_batch(torch.tensor(work), ms, S, "reflection", precision="bf16")
    assert torch.equal(a, b)
    assert [WB.norm_prec(p) for p in WB.WARP_PRECS] == ["bf16", "bf16", "high", "highest"]
    with pytest.raises(ValueError):
        cuda_warp.warp_modes(torch.tensor(work), inv3x3(ms), torch.zeros(5, dtype=torch.int32), 0.0, S, "fp8")


@pytest.mark.parametrize("prec,bwd", [("int8", "bf16"), ("int8", "int8"), ("bf16", "bf16"), ("high", "high")])
def test_cutout_bank_plain_takes_the_rungs(prec, bwd):
    """The bank's plain composition (what the engine's CPU step runs): the
    rung's warp, the bf16 epilogue, and the rung's adjoint under it."""
    from pixray_tpu_torch.ops.color import draw_jitter_params

    inv, md, fill = _bank("mixed")
    gen = torch.Generator().manual_seed(5)
    jitter = draw_jitter_params(gen, 5)
    params = cuda_warp.pack_params(torch.tensor(inv), torch.tensor(md), jitter, torch.rand(5, generator=gen) * 0.1,
                                   fill=0.37)
    work = torch.tensor(_canvas(), requires_grad=True)
    out = cuda_warp.cutout_bank(work, params, S, None, torch.bfloat16, prec, bwd)
    want = WB.warp_modes_prec(work.detach(), torch.tensor(inv), torch.tensor(md), torch.full((5,), 0.37), S, prec)
    pre = cuda_warp.unpack_params(params)
    untouched = ~pre["apply"]
    assert torch.equal(out[untouched].float(), want.to(torch.bfloat16).float()[untouched])
    g = torch.randn(out.shape, generator=gen).to(torch.bfloat16)
    (dwork,) = torch.autograd.grad(out, work, g)
    assert torch.isfinite(dwork).all() and float(dwork.abs().max()) > 0
