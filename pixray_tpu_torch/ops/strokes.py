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

``tile_stroke_lists`` and ``tile_chunk_canvases`` are the plain twins of
the state K4s saves for K5 (each tile's list of the strokes that meet it,
and the tile's canvas at the entry of each chunk of that list), and
``crowded_scene`` a scene that stresses those lists; no path runs them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 16
TILE = (8, 16)  # (height, width) of the kernels' pixel tile: 16x8 measured fastest (PERF.md)


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
    rgb = canvas[..., :3] / torch.maximum(alpha, alpha.new_full((), 1e-6))
    return torch.cat([rgb, alpha], dim=-1)


def clip_like_jnp(x, lo: float, hi: float):
    # jnp.clip is minimum(maximum(x, lo), hi): at a tie the gradient splits
    # in half, where torch.clamp would pass all of it
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


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


def _coverage_at(samples, widths, px, py):
    """(C, P, 2) polylines, (C,) widths, pixel centres px (C|1, 1, 1, W),
    py (C|1, 1, H, 1) → (C, H, W) anti-aliased coverage."""
    seg = lambda k, i: samples[:, k : samples.shape[1] - 1 + k, i][:, :, None, None]
    d2 = _point_segment_dist2(px, py, seg(0, 0), seg(0, 1), seg(1, 0), seg(1, 1))  # (C, P-1, H, W)
    dist = torch.sqrt(torch.amin(d2, dim=1) + 1e-12)
    # linear 1px anti-aliasing ramp around the stroke boundary
    return clip_like_jnp(widths[:, None, None] / 2.0 + 0.5 - dist, 0.0, 1.0)


def stroke_coverage(samples, widths, h: int, w: int):
    """(C, P, 2) polylines, (C,) widths → (C, H, W) anti-aliased coverage."""
    ys = torch.arange(h, dtype=samples.dtype, device=samples.device) + 0.5
    xs = torch.arange(w, dtype=samples.dtype, device=samples.device) + 0.5
    return _coverage_at(samples, widths, xs[None, None, None, :], ys[None, None, :, None])


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


def pack_meta(samples, widths, colors):
    """(N, 9) rows [width, r, g, b, a, bx0, by0, bx1, by1]: per-stroke scalars
    and the bbox with the anti-aliasing margin (JAX ``_pack_meta``; the
    kernels compute the same values from the samples' box in f32)."""
    margin = widths[:, None] / 2.0 + 1.0  # ramp reaches width/2 + 0.5; +slack
    mn = torch.amin(samples, dim=1)  # (N, 2) [x, y]
    mx = torch.amax(samples, dim=1)
    return torch.cat([widths[:, None], colors, mn - margin, mx + margin], dim=-1).float().contiguous()


def _tile_grid(h: int, w: int, tile):
    """Tile origins, row-major over the tiles: (T,) y0 and x0 as int64."""
    th, tw = tile
    ty, tx = torch.arange(0, h, th), torch.arange(0, w, tw)
    return ty[:, None].expand(-1, len(tx)).reshape(-1), tx[None, :].expand(len(ty), -1).reshape(-1)


def tile_stroke_lists(meta, h: int, w: int, tile=TILE):
    """Per tile of the (H, W) canvas, row-major over the tiles: the ascending
    indices of the strokes whose margined bbox (``pack_meta``) meets the tile
    [x0, x0 + tw] x [y0, y0 + th].  Alpha-0 strokes are kept."""
    th, tw = tile
    y0, x0 = (t.to(meta.device, meta.dtype)[None] for t in _tile_grid(h, w, tile))
    m = meta[:, :, None]
    hit = (m[:, 5] <= x0 + tw) & (m[:, 7] >= x0) & (m[:, 6] <= y0 + th) & (m[:, 8] >= y0)  # (N, T)
    return [torch.nonzero(col).flatten() for col in hit.T]


def tile_chunk_canvases(samples, widths, colors, canvas, lists, chunk: int = CHUNK, tile=TILE):
    """The tile-local canvases at the entry of each ``chunk``-stroke piece of
    each tile's list: (T, S, 4, th, tw), S = the most pieces of any tile;
    the pieces a tile lacks, and pixels past the canvas edge, are 0.

    (N, P, 2) samples, (N,) widths, (N, 4) colors, (H, W, 4) premultiplied
    canvas, ``lists`` from ``tile_stroke_lists``.  A stroke off a tile's list
    paints a = 0 on the tile, which leaves it bitwise unchanged, so a tile
    composited over its own list alone is the full canvas there."""
    h, w = canvas.shape[:2]
    th, tw = tile
    dev, dt = samples.device, samples.dtype
    y0, x0 = (t.to(dev) for t in _tile_grid(h, w, tile))
    n_tiles = len(lists)
    counts = torch.tensor([len(l) for l in lists], device=dev)
    k_max = int(counts.max()) if n_tiles else 0
    idx = torch.zeros((n_tiles, k_max), dtype=torch.long, device=dev)
    for t, l in enumerate(lists):
        idx[t, : len(l)] = l
    yi = y0[:, None] + torch.arange(th, device=dev)  # (T, th)
    xi = x0[:, None] + torch.arange(tw, device=dev)  # (T, tw)
    inside = (yi < h)[:, :, None] & (xi < w)[:, None, :]
    c = canvas[yi.clamp(max=h - 1)[:, :, None], xi.clamp(max=w - 1)[:, None, :]].permute(0, 3, 1, 2)
    c = c * inside[:, None]  # (T, 4, th, tw)
    py, px = (yi.to(dt) + 0.5)[:, None, :, None], (xi.to(dt) + 0.5)[:, None, None, :]
    out = c.new_zeros((n_tiles, -(-k_max // chunk), 4, th, tw))
    for k in range(k_max):
        listed = (k < counts)[:, None, None]
        if k % chunk == 0:
            out[:, k // chunk] = c * listed[:, None]
        s = idx[:, k]
        cov = _coverage_at(samples[s], widths[s], px, py)  # (T, th, tw)
        a = cov * colors[s, 3, None, None] * (listed & inside)
        c = torch.cat([colors[s, :3, None, None] * a[:, None], a[:, None]], 1) + (1.0 - a[:, None]) * c
    return out


def crowded_scene():
    """300 short strokes (P = 9, every 17th with alpha 0) inside the 32x32
    region [40, 72) x [24, 56) of a 64x96 canvas, as float32 numpy arrays:
    (h, w, samples (N, P, 2), widths (N,), colors (N, 4), background
    (H, W, 3)).  The lists of its middle tiles take strokes from both of a
    kernel's 128-stroke build rounds into many chunks, and empty tiles lie
    beside them."""
    rng = np.random.default_rng(7)
    n, p = 300, 9
    start = rng.uniform([40.0, 24.0], [72.0, 56.0], (n, 1, 2))
    samples = np.clip(start + np.cumsum(rng.uniform(-2.0, 2.0, (n, p, 2)), 1), [40.0, 24.0], [72.0, 56.0])
    widths = rng.uniform(0.5, 2.0, n)
    colors = rng.uniform(0.0, 1.0, (n, 4))
    colors[::17, 3] = 0.0
    bg = rng.uniform(0.0, 1.0, (64, 96, 3))
    return (64, 96) + tuple(np.asarray(a, np.float32) for a in (samples, widths, colors, bg))
