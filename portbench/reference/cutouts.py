"""Plain float32 cutouts of one step: the random draws, the cut geometry,
the pooled work canvas, the warp, the hue/saturation jitter and the noise.

The draws and the geometry are pixray's cutout scheme as the program under
test defines it, frozen here so that the reference works them out again
from the seed (same generators, same calls, same order): 60% zoom cuts
(random perspective, then a random resized crop), 40% wide cuts (random
affine about the centre, a centre crop, a perspective) over a random gray,
a fixed share of perspective cuts per branch, the zoom cuts padded by
reflection on even steps and by the border on odd ones.  The warp is one
bilinear resample per cut by its inverse homography; its gradient is
autograd's.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NOISE_FAC = 0.1
ZOOM_FRACTION = 0.6
PERSP_P = 0.7
REFLECT, BORDER, FILL = 0, 1, 3


# ---------------------------------------------------------------- geometry
def inv3x3(m):
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
                       torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
                       torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def _basis_to_quad(pts):
    q = torch.stack([pts[..., 0], pts[..., 1], torch.ones_like(pts[..., 0])], dim=-2)
    lam = torch.einsum("...ij,...j->...i", inv3x3(q[..., :3]), q[..., 3])
    return q[..., :3] * lam[..., None, :]


def random_perspective(h, w, scale, mags):
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]])
    inward = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
    dst = corners + inward * mags * scale * torch.tensor([w / 2.0, h / 2.0])
    return torch.matmul(_basis_to_quad(dst), inv3x3(_basis_to_quad(corners.expand_as(dst))))


def crop_box(x0, y0, cw, ch, out_h, out_w):
    sx, sy = out_w / cw, out_h / ch
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, zero, -x0 * sx], -1), torch.stack([zero, sy, -y0 * sy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def work_shape(cut: int, aspect: float):
    if aspect == 1.0:
        return cut, cut
    return (cut, int(round(cut * aspect))) if aspect > 1.0 else (int(round(cut / aspect)), cut)


def wide_ranges(aspect: float):
    if aspect == 1.0:
        n_s = 0.95
        return ((1 - n_s) / 2, (1 - n_s) / 2), (n_s, n_s)
    if aspect > 1.0:
        n_s = 1 / aspect
        return (0.0, (1 - n_s) / 2), (0.9 * n_s, n_s)
    n_s = aspect
    return ((1 - n_s) / 2, 0.0), (0.9 * n_s, n_s)


def draw_cut_params(gen, n: int, aspect: float):
    n_zoom = int(ZOOM_FRACTION * n)
    n_wide = n - n_zoom
    (t0, t1), (s0, s1) = wide_ranges(aspect)
    u = lambda *shape: torch.rand(shape, generator=gen)
    lr0, lr1 = math.log(0.85), math.log(1.2)
    return {"zoom_persp": u(n_zoom, 4, 2), "zoom_area": u(n_zoom) * (0.95 - 0.25) + 0.25,
            "zoom_log_ratio": u(n_zoom) * (lr1 - lr0) + lr0, "zoom_ux": u(n_zoom), "zoom_uy": u(n_zoom),
            "wide_tx": u(n_wide) * (2 * t0) - t0, "wide_ty": u(n_wide) * (2 * t1) - t1,
            "wide_scale": u(n_wide) * (s1 - s0) + s0, "wide_persp": u(n_wide, 4, 2)}


def persp_count(n: int) -> int:
    return int(round(PERSP_P * n))


def cut_matrices(d, cut: int, aspect: float):
    """(zoom, wide) source→cut matrices over the pooled square canvas."""
    wh, ww = work_shape(cut, aspect)
    eye = torch.eye(3)

    def split(p):
        return torch.where((torch.arange(p.shape[0]) < persp_count(p.shape[0]))[:, None, None], p, eye)

    zp = split(random_perspective(wh, ww, 0.40, d["zoom_persp"]))
    area, ratio = d["zoom_area"] * (wh * ww), torch.exp(d["zoom_log_ratio"])
    cw = torch.clamp(torch.sqrt(area * ratio), 1.0, float(ww))
    ch = torch.clamp(torch.sqrt(area / ratio), 1.0, float(wh))
    zoom = torch.matmul(crop_box(d["zoom_ux"] * (ww - cw), d["zoom_uy"] * (wh - ch), cw, ch, cut, cut), zp)

    wp = split(random_perspective(cut, cut, 0.20, d["wide_persp"]))
    s = d["wide_scale"]
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    cx, cy = (ww - 1) / 2.0, (wh - 1) / 2.0
    aff = torch.stack([torch.stack([s, zero, cx - s * cx + d["wide_tx"] * ww], -1),
                       torch.stack([zero, s, cy - s * cy + d["wide_ty"] * wh], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    t = lambda v: torch.tensor(float(v))
    center = crop_box(t((ww - cut) / 2.0), t((wh - cut) / 2.0), t(cut), t(cut), cut, cut)
    wide = torch.matmul(torch.matmul(wp, center), aff)
    if aspect != 1.0:
        sx, sy = ww / cut, wh / cut
        widen = torch.tensor([[sx, 0.0, 0.5 * sx - 0.5], [0.0, sy, 0.5 * sy - 0.5], [0.0, 0.0, 1.0]])
        zoom, wide = torch.matmul(zoom, widen), torch.matmul(wide, widen)
    return zoom, wide


def bank_order(n_zoom: int, n_wide: int):
    """The bank's rows: perspective zoom cuts, perspective wide cuts, then
    the axis-aligned zoom and wide cuts."""
    zoom, wide = torch.arange(n_zoom), n_zoom + torch.arange(n_wide)
    zp, wp = persp_count(n_zoom), persp_count(n_wide)
    return torch.cat([zoom[:zp], wide[:wp], zoom[zp:], wide[wp:]])


def draw_jitter(gen, n: int, hue=0.1, sat=0.1, p=0.8):
    u = torch.rand((3, n), generator=gen)
    return u[0] * (2 * hue) - hue, u[1] * 2 * sat + (1.0 - sat), u[2] < p


def draw_step(gen, gen_device, towers, num_cuts: int, aspect: float, noise_dtype, device):
    """One step's draws, per tower (cut size ``s`` of each entry of
    ``towers``): the fill, then per tower its cut geometry, its jitter, its
    noise factors (host) and its three noise planes (``gen_device``)."""
    fill = float(torch.rand((), generator=gen))
    out = []
    for cut in towers:
        zoom, wide = cut_matrices(draw_cut_params(gen, num_cuts, aspect), cut, aspect)
        jitter = draw_jitter(gen, num_cuts)
        facs = (torch.rand((num_cuts, 1, 1), generator=gen) * NOISE_FAC).to(noise_dtype)
        planes = [torch.randn((num_cuts, cut, cut), generator=gen_device, device=device, dtype=noise_dtype)
                  for _ in range(3)]
        out.append({"zoom": zoom, "wide": wide, "jitter": jitter, "facs": facs, "planes": planes})
    return fill, out


# ---------------------------------------------------------------- pooling
def _windows(n_in: int, n_out: int):
    starts = np.floor(np.arange(n_out) * n_in / n_out).astype(np.int64)
    ends = np.ceil((np.arange(n_out) + 1) * n_in / n_out).astype(np.int64)
    return starts, ends


def pool_to_work(img, cut: int):
    """(H, W, C) → (cut, cut, C): the mean of adaptive average and adaptive
    max pooling; the max's gradient splits evenly between tied maxima."""
    h, w, c = img.shape
    rs, re_ = _windows(h, cut)
    cs, ce = _windows(w, cut)
    dev = img.device

    def avg_matrix(starts, ends, n):
        idx = np.arange(n)
        m = ((idx[None] >= starts[:, None]) & (idx[None] < ends[:, None])).astype(np.float32)
        return torch.from_numpy(m / m.sum(1, keepdims=True)).to(dev)

    avg = torch.einsum("oh,hwc,pw->opc", avg_matrix(rs, re_, h), img, avg_matrix(cs, ce, w))
    kh, kw = int((re_ - rs).max()), int((ce - cs).max())
    ri = torch.from_numpy(np.minimum(rs[:, None] + np.arange(kh), h - 1)).to(dev)
    ci = torch.from_numpy(np.minimum(cs[:, None] + np.arange(kw), w - 1)).to(dev)
    rm = torch.from_numpy(rs[:, None] + np.arange(kh) < re_[:, None]).to(dev)
    cm = torch.from_numpy(cs[:, None] + np.arange(kw) < ce[:, None]).to(dev)
    win = img[ri.reshape(-1)][:, ci.reshape(-1)].reshape(cut, kh, cut, kw, c)
    mask = (rm[:, :, None, None] & cm[None, None])[..., None]
    mx = torch.amax(torch.where(mask, win, torch.tensor(float("-inf"), device=dev)), dim=(1, 3))
    return 0.5 * (avg + mx)


# ---------------------------------------------------------------- warp
def _reflect(x, size: int):
    span = 2.0 * size
    r = torch.fmod(x + 0.5, span)
    r = torch.where((r != 0) & (r < 0), r + span, r)
    r = torch.where(r >= size, span - r - 1e-6, r)
    return r - 0.5


def warp(work, inv, modes, fill: float, cut: int):
    """(H, W, C) canvas, (N, 3, 3) cut→canvas matrices and (N,) padding
    modes → (N, C, cut, cut): bilinear taps, taps off the canvas weigh 0;
    a fill cut adds the fill by the canvas's closed-form bilinear coverage."""
    h, w, c = work.shape
    idx = torch.arange(cut, dtype=torch.float32, device=work.device)
    ys, xs = idx[:, None], idx[None, :]
    m = inv[:, :, :, None, None]
    den = xs * m[:, 2, 0] + ys * m[:, 2, 1] + m[:, 2, 2] + 1e-8
    sx = (xs * m[:, 0, 0] + ys * m[:, 0, 1] + m[:, 0, 2]) / den
    sy = (xs * m[:, 1, 0] + ys * m[:, 1, 1] + m[:, 1, 2]) / den
    md = modes[:, None, None]
    tx = torch.where(md == REFLECT, _reflect(sx, w), torch.where(md == BORDER, sx.clamp(0.0, w - 1.0), sx))
    ty = torch.where(md == REFLECT, _reflect(sy, h), torch.where(md == BORDER, sy.clamp(0.0, h - 1.0), sy))
    x0, y0 = torch.floor(tx), torch.floor(ty)
    wx, wy = (tx - x0)[:, None], (ty - y0)[:, None]
    x0, y0 = x0.clamp(-2, w + 1).long(), y0.clamp(-2, h + 1).long()
    flat = work.reshape(h * w, c)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = flat[(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)].reshape(*yi.shape, c)
        return torch.where(ok[:, None], vals.permute(0, 3, 1, 2), 0.0)

    out = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
           + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)
    cov = (torch.clamp(torch.minimum(sx + 1.0, w - sx), 0.0, 1.0)
           * torch.clamp(torch.minimum(sy + 1.0, h - sy), 0.0, 1.0))
    return out + torch.where(md == FILL, (1.0 - cov) * fill, 0.0)[:, None]


# ---------------------------------------------------------------- jitter
def _clip01(x):
    """Clamp to [0, 1] with half the gradient at a bound (min of max)."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def jitter(r, g, b, hue, sat):
    """Hue shift and saturation scale through HSV; gray and dark pixels
    keep hue and saturation 0 without a division by zero in either pass."""
    r, g, b = _clip01(r), _clip01(g), _clip01(b)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    gray, dark = delta <= 1e-6, maxc <= 1e-6
    s = torch.where(dark, 0.0, delta / torch.where(dark, 1.0, maxc))
    sd = torch.where(gray, 1.0, delta)
    rc, gc, bc = (maxc - r) / sd, (maxc - g) / sd, (maxc - b) / sd
    hh = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    hh = torch.where(gray, 0.0, torch.remainder(hh / 6.0, 1.0))
    hh = torch.remainder(hh + hue, 1.0)
    s = _clip01(s * sat)
    v = maxc
    i = torch.floor(hh * 6.0)
    f = hh * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*c):
        out = c[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, c[k], out)
        return out

    return pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)


def bank(work, draws: dict, fill: float, cut: int, reflect: bool):
    """One tower's (N, 3, cut, cut) cutout bank in float32."""
    zoom, wide = draws["zoom"], draws["wide"]
    nz, nw = zoom.shape[0], wide.shape[0]
    order = bank_order(nz, nw)
    inv = inv3x3(torch.cat([zoom, wide])[order].float()).to(work.device)
    modes = torch.cat([torch.full((nz,), REFLECT if reflect else BORDER), torch.full((nw,), FILL)])[order]
    out = warp(work, inv, modes.to(work.device), fill, cut)
    hue, sat, apply = (x.to(work.device) for x in draws["jitter"])
    r, g, b = out.unbind(1)
    jr, jg, jb = jitter(r, g, b, hue[:, None, None], sat[:, None, None])
    ap = apply[:, None, None]
    r, g, b = torch.where(ap, jr, r), torch.where(ap, jg, g), torch.where(ap, jb, b)
    facs = draws["facs"].float().to(work.device)
    return torch.stack([x + facs * z.float() for x, z in zip((r, g, b), draws["planes"])], 1)
