"""Port ops against the JAX package: cut geometry from the same uniforms,
pooling, the jitter epilogue and the gradient-shaping primitives.

Everything runs in float32 on the CPU.  Tolerances: 3x3 geometry 1e-5
relative for single affines, 1e-4 where a homography is solved or matrices
are chained (adjugates of f32 products summed in another order); 1e-5
absolute for pooling and the HSV round trip, 1e-4 for the jitter gradient
(its HSV divisions amplify rounding); 1e-6 for the loss primitives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.engine import cutouts as JC
from pixray_tpu.engine.prompts import PromptTable as JTable
from pixray_tpu.engine.prompts import prompt_losses as j_prompt_losses
from pixray_tpu.ops import color as JCOL
from pixray_tpu.ops import grad as JG
from pixray_tpu.ops import warp as JW
from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.prompts import PromptTable, prompt_losses
from pixray_tpu_torch.ops import color as COL
from pixray_tpu_torch.ops import grad as G
from pixray_tpu_torch.ops import warp as W

KEY = jax.random.PRNGKey(11)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a), np.asarray(b),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------------ geometry
def _crop_draws(key, scale=(0.25, 0.95), ratio=(0.85, 1.2)):
    k_area, k_ratio, k_x, k_y = jax.random.split(key, 4)
    u = jax.random.uniform
    return (u(k_area, (), minval=scale[0], maxval=scale[1]),
            u(k_ratio, (), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])),
            u(k_x, ()), u(k_y, ()))


def _affine_draws(key, translate, scale_range):
    k_t, k_s, _k_r = jax.random.split(key, 3)
    u = jax.random.uniform
    return (u(k_t, (), minval=-translate[0], maxval=translate[0]),
            u(jax.random.fold_in(k_t, 1), (), minval=-translate[1], maxval=translate[1]),
            u(k_s, (), minval=scale_range[0], maxval=scale_range[1]))


def test_inv3x3_and_homography():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((6, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    close(W.inv3x3(t(m)), jax.vmap(JW.inv3x3)(jnp.asarray(m)))
    src = rng.uniform(0, 30, (4, 2)).astype(np.float32)
    dst = src + rng.uniform(-3, 3, (4, 2)).astype(np.float32)
    close(W.homography_from_points(t(src), t(dst)), JW.homography_from_points(src, dst), rtol=1e-4)


def test_random_perspective_same_uniforms():
    mags = jax.random.uniform(KEY, (4, 2))
    close(W.random_perspective(21, 37, 0.4, t(mags)), JW.random_perspective(KEY, 21, 37, 0.4), rtol=1e-4)


def test_random_resized_crop_same_uniforms():
    area, log_r, ux, uy = _crop_draws(KEY)
    port = W.random_resized_crop(32, 57, 32, t(area), t(log_r), t(ux), t(uy))
    close(port, JW.random_resized_crop(KEY, 32, 57, 32, scale=(0.25, 0.95), ratio=(0.85, 1.2)))


def test_random_affine_and_center_crop_same_uniforms():
    tr, sc = (0.0, 0.1), (0.5, 0.6)
    tx, ty, s = _affine_draws(KEY, tr, sc)
    port = W.random_affine(32, 57, t(tx), t(ty), t(s), t(0.0))
    close(port, JW.random_affine(KEY, 32, 57, tr, sc))
    close(W.center_crop_transform(32, 57, 32), JW.center_crop_transform(32, 57, 32))


@pytest.mark.parametrize("cutn,aspect", [(8, 96 / 54), (13, 1.0), (10, 0.75)])
def test_cut_transforms_match_jax_sampler(cutn, aspect):
    """The whole bank (zoom/wide split, fixed perspective split, square-work
    fold) from the JAX sampler's own draws."""
    cut = 32
    wh, ww = JC.work_canvas_shape(cut, aspect)
    n_zoom, n_wide = JC.split_counts(cutn)
    translate, scale_range = JC._wide_affine_params(aspect)
    kz, kw = jax.random.split(KEY)
    draws = {k: [] for k in ("zoom_persp", "zoom_area", "zoom_log_ratio", "zoom_ux", "zoom_uy",
                             "wide_tx", "wide_ty", "wide_scale", "wide_persp")}
    for k in jax.random.split(kz, n_zoom):
        k1, k2, _ = jax.random.split(k, 3)
        draws["zoom_persp"].append(jax.random.uniform(k1, (4, 2)))
        for name, v in zip(("zoom_area", "zoom_log_ratio", "zoom_ux", "zoom_uy"), _crop_draws(k2)):
            draws[name].append(v)
    for k in jax.random.split(kw, n_wide):
        k1, k2, _ = jax.random.split(k, 3)
        for name, v in zip(("wide_tx", "wide_ty", "wide_scale"), _affine_draws(k1, translate, scale_range)):
            draws[name].append(v)
        draws["wide_persp"].append(jax.random.uniform(k2, (4, 2)))
    draws = {k: t(np.stack([np.asarray(x) for x in v])) for k, v in draws.items()}
    zoom, wide = C.cut_transforms(draws, cut, aspect)
    j_zoom, j_wide = JC.sample_cut_transforms(KEY, cut, cutn, aspect)
    assert (wh, ww) == C.work_canvas_shape(cut, aspect)
    close(zoom, j_zoom, rtol=1e-4, atol=1e-4)
    close(wide, j_wide, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ pooling
def test_pool_to_work_with_ties_forward_and_grad():
    """Blocky canvas (flat cells, many exact ties inside the max windows):
    the max-pool gradient must split between ties as JAX's does."""
    rng = np.random.default_rng(4)
    img = np.repeat(np.repeat(rng.random((9, 16, 3)), 6, axis=0), 6, axis=1).astype(np.float32)
    cot = rng.standard_normal((32, 32, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: JC.pool_to_work(x, 32, 96 / 54), jnp.asarray(img))
    (ref_grad,) = vjp(jnp.asarray(cot))
    x = t(img).requires_grad_(True)
    out = C.pool_to_work(x, 32)
    (grad,) = torch.autograd.grad(out, x, t(cot))
    close(out, ref)
    close(grad, ref_grad)


# ------------------------------------------------------------------ jitter
def _planes(ties: bool):
    rng = np.random.default_rng(5)
    r, g, b = rng.uniform(-0.1, 1.1, (3, 6, 9, 11)).astype(np.float32)
    if ties:  # exact grays, r==g pairs, exact 0/1 bounds
        g[:, :3] = r[:, :3]
        b[:, :2] = r[:, :2]
        r[:, 5], g[:, 5], b[:, 5] = 0.0, 0.0, 1.0
        r[:, 6] = g[:, 6] = b[:, 6] = 0.5
    return r, g, b


@pytest.mark.parametrize("ties", [False, True])
def test_jitter_planes_forward_and_grad(ties):
    r, g, b = _planes(ties)
    keys = jax.random.split(KEY, r.shape[0])
    params = jax.vmap(lambda k: JCOL._draw_jitter_params(k, 0.1, 0.1, 0.8))(keys)
    rng = np.random.default_rng(6)
    cots = [rng.standard_normal(r.shape).astype(np.float32) for _ in range(3)]

    def jf(rr, gg, bb):
        return JCOL.random_color_jitter_planes(keys, rr, gg, bb, hue=0.1, saturation=0.1, p=0.8)

    ref, vjp = jax.vjp(jf, *map(jnp.asarray, (r, g, b)))
    ref_grads = vjp(tuple(map(jnp.asarray, cots)))
    ins = [t(x).requires_grad_(True) for x in (r, g, b)]
    port_params = (t(params[0]), t(params[1]), torch.tensor(np.asarray(params[2])))
    out = COL.random_color_jitter_planes(port_params, *ins)
    grads = torch.autograd.grad(out, ins, [t(c) for c in cots])
    for o, ro in zip(out, ref):
        close(o, ro)
    for gr, rg in zip(grads, ref_grads):
        assert np.all(np.isfinite(gr.numpy()))
        close(gr, rg, atol=1e-4)


# ------------------------------------------------------------------ losses
def test_spherical_dist_loss():
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ref, vjp = jax.vjp(JG.spherical_dist_loss, jnp.asarray(x), jnp.asarray(y))
    ref_gx, _ = vjp(jnp.ones(5))
    xt = t(x).requires_grad_(True)
    out = G.spherical_dist_loss(xt, t(y))
    (gx,) = torch.autograd.grad(out.sum(), xt)
    close(out, ref, atol=1e-6)
    close(gx, ref_gx, atol=1e-6)


def test_replace_grad_routes_the_broadcast_gradient():
    rng = np.random.default_rng(8)
    fwd, bwd = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal((1, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    ref_gb = jax.grad(lambda b: jnp.sum(JG.replace_grad(jnp.asarray(fwd), b) * w))(jnp.asarray(bwd))
    bt = t(bwd).requires_grad_(True)
    out = G.replace_grad(t(fwd), bt)
    (gb,) = torch.autograd.grad((out * t(w)).sum(), bt)
    close(out, fwd, atol=0)
    close(gb, ref_gb, atol=1e-6)


def test_clamp_with_grad():
    x = np.array([-0.5, 0.2, 0.9, 1.4, 1.1], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 1.0], np.float32)
    ref, vjp = jax.vjp(lambda v: JG.clamp_with_grad(v, 0.0, 1.0), jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    out = G.clamp_with_grad(xt, 0.0, 1.0)
    (gx,) = torch.autograd.grad(out, xt, t(g))
    close(out, ref, atol=0)
    close(gx, ref_g, atol=0)


def test_prompt_losses_weights_and_stops():
    rng = np.random.default_rng(9)
    rows = [(rng.standard_normal(16), 1.0, float("-inf")),
            (rng.standard_normal((2, 16)), -0.5, float("-inf")),
            (rng.standard_normal(16), 2.0, 0.9)]
    iii = rng.standard_normal((6, 16)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: j_prompt_losses(v, JTable.from_rows(rows)), jnp.asarray(iii))
    (ref_g,) = vjp(jnp.ones(ref.shape))
    it = t(iii).requires_grad_(True)
    out = prompt_losses(it, PromptTable.from_rows(rows, 16))
    (gi,) = torch.autograd.grad(out.sum(), it)
    close(out, ref, atol=1e-6)
    close(gi, ref_g, atol=1e-6)
