"""Differentiable Bézier-stroke rasterizer, plain PyTorch (port of ``pixray_tpu/ops/strokes.py``).

Each stroke's piecewise-cubic path is sampled into a polyline by one
product with a fixed Bernstein basis, the distance from every pixel centre
to the polyline is the minimum over its segments, and coverage is a 1-px
linear anti-aliasing ramp.  Strokes composite with premultiplied "over" in
painter order: pairwise inside a chunk of 16, sequentially across chunks.

This is the plain version of the CUDA kernels K4, K4s and K5
(``ops/cuda_strokes.py``): the CPU path, and the reference they are held
against on the card.  Its gradients follow the JAX function's: ``torch.amin``
and ``minimum(maximum(...))`` split the gradient evenly at ties, as
``jnp.min`` and ``jnp.clip`` do.  One difference: the projection parameter
of each segment takes no gradient (the envelope form of K5 and of the TPU
kernel; see ``_point_segment_dist2``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 16


def bezier_basis(segment_counts, max_segments: int, samples_per_segment: int = 8) -> torch.Tensor:
    """Bernstein sampling basis for piecewise-cubic paths.

    segment_counts: (N,) ints in [1, max_segments].  Control-point layout is the
    pydiffvg Path convention: 1 + 3*s points for s segments.  Strokes with fewer
    than max_segments segments repeat their endpoint (degenerate tail segments do
    not affect distance fields).  Returns (N, P, V) with P = max_segments *
    samples_per_segment + 1, V = 1 + 3*max_segments.
    """
    n = len(segment_counts)
    v = 1 + 3 * max_segments
    p = max_segments * samples_per_segment + 1
    basis = np.zeros((n, p, v), dtype=np.float32)
    for i, segs in enumerate(segment_counts):
        ts = np.linspace(0.0, 1.0, p)
        for j, t in enumerate(ts):
            # position along this stroke's own s segments
            u = t * segs
            k = min(int(u), segs - 1)
            lu = u - k
            c0, c1, c2, c3 = 3 * k, 3 * k + 1, 3 * k + 2, 3 * k + 3
            b = np.array(
                [(1 - lu) ** 3, 3 * lu * (1 - lu) ** 2, 3 * lu**2 * (1 - lu), lu**3]
            )
            basis[i, j, c0] += b[0]
            basis[i, j, c1] += b[1]
            basis[i, j, c2] += b[2]
            basis[i, j, c3] += b[3]
    return torch.from_numpy(basis)


def sample_paths(basis, points):
    """(N, P, V) basis, (N, V, 2) control points → (N, P, 2) polyline samples."""
    return torch.einsum("npv,nvd->npd", basis, points)


def premultiply(background):
    """(H, W, 3) or straight (H, W, 4) RGBA → premultiplied (H, W, 4)."""
    if background.shape[-1] == 3:
        background = torch.cat([background, torch.ones_like(background[..., :1])], dim=-1)
    return torch.cat([background[..., :3] * background[..., 3:4], background[..., 3:4]], dim=-1)


def unpremultiply(canvas):
    """Premultiplied (H, W, 4) → straight alpha, with the 1e-6 alpha floor."""
    alpha = canvas[..., 3:4]
    rgb = canvas[..., :3] / torch.maximum(alpha, alpha.new_tensor(1e-6))
    return torch.cat([rgb, alpha], dim=-1)


def clip_like_jnp(x, lo: float, hi: float):
    # jnp.clip is minimum(maximum(x, lo), hi): at a tie the gradient splits
    # in half, where torch.clamp would pass all of it
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from the pixel grid to segments (broadcasting).

    The projection parameter t enters without a gradient (the envelope
    form, as in K5 and the TPU kernel): t minimizes the distance, so its
    derivative drops out up to the 1e-8 eps.  Differentiating through it
    adds only float rounding, amplified by 1/dist at pixel centres on the
    centre line of strokes under 1 px wide (line_sketch starts at 0.43 px)."""
    abx, aby = bx - ax, by - ay
    with torch.no_grad():
        ab2 = abx * abx + aby * aby + 1e-8
        t = ((px - ax) * abx + (py - ay) * aby) / ab2
        t = clip_like_jnp(t, 0.0, 1.0)
    cx = ax + t * abx
    cy = ay + t * aby
    return (px - cx) ** 2 + (py - cy) ** 2


def stroke_coverage(samples, widths, h: int, w: int):
    """(C, P, 2) polylines, (C,) widths → (C, H, W) anti-aliased coverage."""
    ys = torch.arange(h, dtype=samples.dtype, device=samples.device) + 0.5
    xs = torch.arange(w, dtype=samples.dtype, device=samples.device) + 0.5
    px, py = xs[None, None, None, :], ys[None, None, :, None]
    seg = lambda k, i: samples[:, k : samples.shape[1] - 1 + k, i][:, :, None, None]
    d2 = _point_segment_dist2(px, py, seg(0, 0), seg(0, 1), seg(1, 0), seg(1, 1))  # (C, P-1, H, W)
    dist = torch.sqrt(torch.amin(d2, dim=1) + 1e-12)
    # linear 1px anti-aliasing ramp around the stroke boundary
    return clip_like_jnp(widths[:, None, None] / 2.0 + 0.5 - dist, 0.0, 1.0)


def _over(top, bottom):
    """Associative premultiplied 'over': layers are (..., 4) premultiplied RGBA."""
    return top + (1.0 - top[..., 3:4]) * bottom


def _reduce_over(layers):
    """(C, H, W, 4) premultiplied layers, painter order (0 = bottom) → (H, W, 4)."""
    while layers.shape[0] > 1:
        if layers.shape[0] % 2 == 1:
            layers = torch.cat([layers, torch.zeros_like(layers[:1])], dim=0)
        layers = _over(layers[1::2], layers[0::2])
    return layers[0]


def _merged_chunk(samples, widths, colors, h: int, w: int):
    cov = stroke_coverage(samples, widths, h, w)  # (C, H, W)
    a = cov * colors[:, 3, None, None]
    rgb = colors[:, None, None, :3] * a[..., None]
    return _reduce_over(torch.cat([rgb, a[..., None]], dim=-1))


def composite_premult(samples, widths, colors, canvas, chunk: int = CHUNK, prefixes=None):
    """Paint N strokes over a premultiplied (H, W, 4) canvas, chunk by chunk.

    Each chunk is recomputed in the backward (``checkpoint``), as the JAX
    function's ``jax.checkpoint`` does: otherwise autograd would keep every
    chunk's (strokes x segments x H x W) distance field.  ``prefixes``, a
    list, receives the canvas at each chunk's entry (what K4s stores)."""
    n = samples.shape[0]
    h, w = canvas.shape[:2]
    pad = (-n) % chunk
    if pad:
        samples = torch.cat([samples, samples.new_zeros((pad,) + samples.shape[1:])], 0)
        widths = torch.cat([widths, widths.new_zeros((pad,))], 0)
        colors = torch.cat([colors, colors.new_zeros((pad, 4))], 0)
    for c in range(0, n + pad, chunk):
        if prefixes is not None:
            prefixes.append(canvas)
        merged = checkpoint(_merged_chunk, samples[c : c + chunk], widths[c : c + chunk],
                            colors[c : c + chunk], h, w, use_reentrant=False)
        canvas = _over(merged, canvas)
    return canvas


def render_strokes(points, widths, colors, basis, h: int, w: int, background, chunk: int = CHUNK):
    """Render N strokes over a background.

    points: (N, V, 2) control points (canvas px); widths: (N,); colors: (N, 4);
    basis: (N, P, V); background: (H, W, 4) straight-alpha RGBA or (H, W, 3).
    Returns (H, W, 4) straight-alpha canvas.
    """
    canvas = premultiply(background)
    if canvas.shape[:2] != (h, w):
        raise ValueError(f"background {tuple(background.shape)} is not {h}x{w}")
    canvas = composite_premult(sample_paths(basis, points), widths, colors, canvas, chunk)
    return unpremultiply(canvas)
