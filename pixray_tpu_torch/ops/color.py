"""Hue/saturation jitter of the cutout bank (port of ``pixray_tpu/ops/color.py``).

Plane form: separate (N, H, W) r/g/b arrays, float32 internal math, outputs
in the input dtype.  The gray guard is the JAX package's double-where: a
plain ``where(cond, x/d, 0)`` still differentiates the untaken branch and
its 1/d² terms go Inf/NaN at gray pixels (d → 0, common on bf16 cutouts and
constant fills), so a safe denominator is substituted BEFORE the division.
``_jclip`` clamps with ``minimum(maximum(...))`` so a value exactly at a
bound gets half the gradient, as ``jnp.clip`` gives (``torch.clamp`` gives
all of it).
"""

from __future__ import annotations

import torch


def _jclip(x, lo: float, hi: float):
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _rgb_to_hsv_planes(r, g, b):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    gray = delta <= 1e-6
    dark = maxc <= 1e-6
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    one = torch.ones((), dtype=r.dtype, device=r.device)
    s = torch.where(dark, zero, delta / torch.where(dark, one, maxc))

    safe_delta = torch.where(gray, one, delta)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(gray, zero, torch.remainder(h / 6.0, 1.0))
    return h, s, v


def _hsv_to_rgb_planes(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)


def jitter_planes(r, g, b, hue_shift, sat_factor):
    """Hue shift (fraction of the circle) and saturation scale of three planes."""
    dtype = r.dtype
    rf = _jclip(r.float(), 0.0, 1.0)
    gf = _jclip(g.float(), 0.0, 1.0)
    bf = _jclip(b.float(), 0.0, 1.0)
    h, s, v = _rgb_to_hsv_planes(rf, gf, bf)
    h = torch.remainder(h + hue_shift, 1.0)
    s = _jclip(s * sat_factor, 0.0, 1.0)
    ro, go, bo = _hsv_to_rgb_planes(h, s, v)
    return ro.to(dtype), go.to(dtype), bo.to(dtype)


def _split_max(a, b, g):
    """Gradient of ``torch.maximum(a, b)`` to (a, b): halves at a tie."""
    half = g / 2
    return (torch.where(a == b, half, torch.where(a > b, g, 0.0)),
            torch.where(a == b, half, torch.where(a < b, g, 0.0)))


def _split_min(a, b, g):
    """Gradient of ``torch.minimum(a, b)`` to (a, b): halves at a tie."""
    return _split_max(b, a, g)


def _jclip_adjoint(x, g):
    """Gradient of ``_jclip(x, 0, 1)`` to x: half at x == 0 and at x == 1."""
    y = torch.maximum(x, torch.zeros_like(x))
    gy, _ = _split_min(y, torch.ones_like(y), g)
    gx, _ = _split_max(x, torch.zeros_like(x), gy)
    return gx


def jitter_planes_adjoint(r, g, b, hue_shift, sat_factor, gr, gg, gb):
    """The vector-Jacobian product of :func:`jitter_planes`, written out.

    Takes the input planes (any float dtype), the per-cut parameters and the
    f32 cotangents of the three outputs; returns the f32 cotangents of the
    three inputs.  These are the formulas the cutout-bank backward kernel
    (``csrc/warp.cu``) evaluates per pixel, with autograd's tie rules:
    ``maximum``/``minimum`` (maxc, minc and ``_jclip``) halve the gradient
    at a tie; the ``maxc == r`` / ``maxc == g`` selects route it to one
    branch; the double-wheres give zero at gray and dark pixels; ``floor``
    carries none and ``remainder`` passes it through.  The caller rounds the
    result to the input dtype, where the ``.float()`` of the forward rounds."""
    R, G, B = (_jclip(x.float(), 0.0, 1.0) for x in (r, g, b))
    m1 = torch.maximum(R, G)
    maxc = torch.maximum(m1, B)
    n1 = torch.minimum(R, G)
    minc = torch.minimum(n1, B)
    v = maxc
    delta = maxc - minc
    gray = delta <= 1e-6
    dark = maxc <= 1e-6
    md = torch.where(dark, 1.0, maxc)
    s_raw = delta / md
    s = torch.where(dark, 0.0, s_raw)
    sd = torch.where(gray, 1.0, delta)
    rc, gc, bc = ((maxc - x) / sd for x in (R, G, B))
    on_r = maxc == R
    on_g = ~on_r & (maxc == G)
    on_b = ~on_r & ~on_g
    h = torch.where(on_r, bc - gc, torch.where(on_g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(gray, 0.0, torch.remainder(h / 6.0, 1.0))
    h = torch.remainder(h + hue_shift, 1.0)
    x = s * sat_factor
    s2 = _jclip(x, 0.0, 1.0)
    h6 = h * 6.0
    f = h6 - torch.floor(h6)
    sector = torch.remainder(torch.floor(h6).to(torch.int32), 6)

    def pick(*per_sector):
        out = torch.zeros_like(gr)
        for k, c in enumerate(per_sector):
            if c is not None:
                out = torch.where(sector == k, c, out)
        return out

    # the sector select: which output carries v, p, q and t
    g_v = pick(gr, gg, gg, gb, gb, gr)
    g_p = pick(gb, gb, gr, gr, gg, gg)
    g_q = pick(None, gr, None, gg, None, gb)
    g_t = pick(gg, None, gb, None, gr, None)
    # p = v(1 - s2), q = v(1 - s2 f), t = v(1 - s2 (1 - f))
    g_w = -(g_q * v)
    g_u = -(g_t * v)
    g_v = g_v + g_p * (1.0 - s2) + g_q * (1.0 - s2 * f) + g_t * (1.0 - s2 * (1.0 - f))
    g_s2 = -(g_p * v) + g_w * f + g_u * (1.0 - f)
    g_f = g_w * s2 - g_u * s2
    # f = 6h - floor(6h); both remainders pass the gradient; gray → 0
    g_h0 = torch.where(gray, 0.0, g_f * 6.0) / 6.0
    g_rc = torch.where(on_g, g_h0, 0.0) - torch.where(on_b, g_h0, 0.0)
    g_gc = torch.where(on_b, g_h0, 0.0) - torch.where(on_r, g_h0, 0.0)
    g_bc = torch.where(on_r, g_h0, 0.0) - torch.where(on_g, g_h0, 0.0)
    # rc = (maxc - R) / sd, likewise gc and bc
    g_max = g_rc / sd + g_gc / sd + g_bc / sd
    g_R, g_G, g_B = -(g_rc / sd), -(g_gc / sd), -(g_bc / sd)
    g_sd = -g_rc * (rc / sd) - g_gc * (gc / sd) - g_bc * (bc / sd)
    g_delta = torch.where(gray, 0.0, g_sd)
    # s = delta / maxc away from dark pixels
    g_s = torch.where(dark, 0.0, _jclip_adjoint(x, g_s2) * sat_factor)
    g_delta = g_delta + g_s / md
    g_max = g_max + torch.where(dark, 0.0, -g_s * (s_raw / md)) + g_delta + g_v
    g_min = -g_delta
    g_m1, g_b3 = _split_max(m1, B, g_max)
    g_r1, g_g1 = _split_max(R, G, g_m1)
    g_n1, g_b4 = _split_min(n1, B, g_min)
    g_r2, g_g2 = _split_min(R, G, g_n1)
    return tuple(_jclip_adjoint(xin.float(), d + d1 + d2)
                 for xin, d, d1, d2 in ((r, g_R, g_r1, g_r2), (g, g_G, g_g1, g_g2), (b, g_B, g_b3, g_b4)))


def draw_jitter_params(gen, n: int, hue=0.1, saturation=0.1, p=0.8):
    """Per-cut (hue_shift, sat_factor, apply) draws from a CPU generator."""
    u = torch.rand((3, n), generator=gen)
    hue_shift = u[0] * (2 * hue) - hue
    lo = max(0.0, 1.0 - saturation)
    sat_factor = u[1] * ((1.0 + saturation) - lo) + lo
    return hue_shift, sat_factor, u[2] < p


def random_color_jitter_planes(params, r, g, b):
    """Bank jitter of (N, H, W) planes by per-cut ``params`` =
    (hue_shift (N,), sat_factor (N,), apply (N,) bool)."""
    hs, sf, apply = (x.to(r.device, non_blocking=True) for x in params)
    hs = hs[:, None, None]
    sf = sf[:, None, None]
    ap = apply[:, None, None]
    ro, go, bo = jitter_planes(r, g, b, hs, sf)
    return torch.where(ap, ro, r), torch.where(ap, go, g), torch.where(ap, bo, b)
