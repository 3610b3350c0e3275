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
