"""Cutout pipeline: pooling, cut geometry and the cutout bank (port of ``pixray_tpu/engine/cutouts.py``).

The path ported is the JAX package's default one:

- the canvas is avg+max pooled once to a SQUARE working canvas of the
  perceptor's resolution, and the aspect re-widening is folded into every
  cut matrix (``work_from_pooled_matrix``);
- 60% "zoom" cuts (random perspective ∘ random resized crop), padded by
  reflection or border on alternate iterations, and 40% "wide" cuts (random
  affine ∘ centre crop ∘ perspective) composited over a random gray;
- a FIXED count of perspective cuts per branch (``persp_split``): the
  perspective cuts go through the CUDA warp kernels in one launch, the
  axis-aligned rest through two matmuls per cut;
- a channel-major (N, 3, S, S) bank, then hue/saturation jitter and
  additive noise per channel plane.

Random draws are explicit: the cut geometry and jitter parameters come from
a CPU ``torch.Generator`` (they are tiny and the matrices are built on the
host), the noise planes from a generator on the canvas's device.  Every
function that draws also accepts the draws, so tests feed the JAX
package's own draws.
"""

from __future__ import annotations

import math

import torch

from pixray_tpu_torch.ops import warp as W
from pixray_tpu_torch.ops.color import draw_jitter_params, random_color_jitter_planes
from pixray_tpu_torch.ops.cuda_warp import warp_batch_modes
from pixray_tpu_torch.ops.pool import adaptive_avg_pool, adaptive_max_pool
from pixray_tpu_torch.ops.warp_batch import warp_batch_separable

NOISE_FAC = 0.1
ZOOM_FRACTION = 0.6
PERSP_P = 0.7  # per-cut perspective probability of the reference augmentations


def persp_split(n: int) -> tuple[int, int]:
    """(n_perspective, n_separable) for a branch of ``n`` cuts."""
    n_p = int(round(PERSP_P * n))
    return n_p, n - n_p


def split_counts(cutn: int) -> tuple[int, int]:
    n_zoom = int(ZOOM_FRACTION * cutn)
    return n_zoom, cutn - n_zoom


def work_canvas_shape(cut_size: int, aspect: float) -> tuple[int, int]:
    """Shape of the virtual aspect-re-widened canvas the cut geometry is sampled in."""
    if aspect == 1.0:
        return (cut_size, cut_size)
    if aspect > 1.0:
        return (cut_size, int(round(cut_size * aspect)))
    return (int(round(cut_size / aspect)), cut_size)


def work_from_pooled_matrix(cut_size: int, aspect: float):
    """(3, 3) affine from pooled-square coords to virtual work-canvas coords
    (half-pixel centres: x_w = (x_p + 0.5) * (ww / pw) - 0.5 per axis)."""
    wh, ww = work_canvas_shape(cut_size, aspect)
    sx = ww / cut_size
    sy = wh / cut_size
    return torch.tensor(
        [[sx, 0.0, 0.5 * sx - 0.5], [0.0, sy, 0.5 * sy - 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32,
    )


def pool_to_work(image, cut_size: int):
    """(H, W, C) canvas → (cut, cut, C) working canvas: mean of avg and max pooling."""
    return 0.5 * (
        adaptive_avg_pool(image, cut_size, cut_size) + adaptive_max_pool(image, cut_size, cut_size)
    )


def _wide_affine_params(aspect: float):
    if aspect == 1.0:
        n_s = 0.95
        n_t = (1 - n_s) / 2
        return (n_t, n_t), (n_s, n_s)
    if aspect > 1.0:
        n_s = 1 / aspect
        n_t = (1 - n_s) / 2
        return (0.0, n_t), (0.9 * n_s, n_s)
    n_s = aspect
    n_t = (1 - n_s) / 2
    return (n_t, 0.0), (0.9 * n_s, n_s)


def draw_cut_params(gen, cutn: int, aspect: float):
    """Random draws for one bank, scaled to the ranges the JAX sampler uses."""
    n_zoom, n_wide = split_counts(cutn)
    (t0, t1), (s0, s1) = _wide_affine_params(aspect)

    def u(*shape):
        return torch.rand(shape, generator=gen)

    lr0, lr1 = math.log(0.85), math.log(1.2)
    return {
        "zoom_persp": u(n_zoom, 4, 2),
        "zoom_area": u(n_zoom) * (0.95 - 0.25) + 0.25,
        "zoom_log_ratio": u(n_zoom) * (lr1 - lr0) + lr0,
        "zoom_ux": u(n_zoom),
        "zoom_uy": u(n_zoom),
        "wide_tx": u(n_wide) * (2 * t0) - t0,
        "wide_ty": u(n_wide) * (2 * t1) - t1,
        "wide_scale": u(n_wide) * (s1 - s0) + s0,
        "wide_persp": u(n_wide, 4, 2),
    }


def cut_transforms(draws, cut_size: int, aspect: float):
    """(zoom (n_zoom, 3, 3), wide (n_wide, 3, 3)) src→dst matrices over the
    pooled square canvas.  Under the fixed perspective split the first
    ``persp_split(n)[0]`` cuts of each branch carry perspective and the rest
    are axis-aligned (``render_cutouts`` relies on this order)."""
    wh, ww = work_canvas_shape(cut_size, aspect)
    eye = torch.eye(3)

    def with_split(p):
        n_p, _ = persp_split(p.shape[0])
        keep = (torch.arange(p.shape[0]) < n_p)[:, None, None]
        return torch.where(keep, p, eye)

    zp = with_split(W.random_perspective(wh, ww, 0.40, draws["zoom_persp"]))
    crop = W.random_resized_crop(wh, ww, cut_size, draws["zoom_area"], draws["zoom_log_ratio"],
                                 draws["zoom_ux"], draws["zoom_uy"])
    zoom = W.mm3(crop, zp)

    wp = with_split(W.random_perspective(cut_size, cut_size, 0.20, draws["wide_persp"]))
    aff = W.random_affine(wh, ww, draws["wide_tx"], draws["wide_ty"], draws["wide_scale"],
                          torch.zeros_like(draws["wide_scale"]))
    center = W.center_crop_transform(wh, ww, cut_size)
    wide = W.mm3(W.mm3(wp, center), aff)

    if aspect != 1.0:
        s = work_from_pooled_matrix(cut_size, aspect)
        zoom, wide = W.mm3(zoom, s), W.mm3(wide, s)
    return zoom, wide


def draw_noise(gen, n: int, cut_size: int, dtype, device):
    """Per-cut noise factors (N, 1, 1) and three (N, S, S) gaussian planes."""
    facs = (torch.rand((n, 1, 1), generator=gen, device=device) * NOISE_FAC).to(dtype)
    planes = [torch.randn((n, cut_size, cut_size), generator=gen, device=device, dtype=dtype)
              for _ in range(3)]
    return facs, planes


def render_cutouts(work, transforms, cut_size: int, *, reflect_padding: bool,
                   fill_color: float, jitter=None, noise=None, compute_dtype=None):
    """The (N, 3, S, S) cutout bank from the working canvas.

    transforms: (zoom, wide) matrices from ``cut_transforms``.
    reflect_padding: zoom cuts pad by reflection (True) or border (False).
    fill_color: the wide cuts' gray.
    jitter: (hue_shift, sat_factor, apply) per cut, or None for no jitter.
    noise: (facs (N, 1, 1), [3 planes (N, S, S)]) or None for no noise.
    compute_dtype: dtype of the post-warp epilogue (None = float32)."""
    zoom_ms, wide_ms = transforms
    n_zp, n_zs = persp_split(zoom_ms.shape[0])
    n_wp, n_ws = persp_split(wide_ms.shape[0])
    zoom_mode = 0 if reflect_padding else 1

    def bank_modes(nz, nw):
        modes = torch.cat([torch.full((nz,), zoom_mode, dtype=torch.int32),
                           torch.full((nw,), 2, dtype=torch.int32)])
        fill_mask = torch.cat([torch.zeros(nz, dtype=torch.bool), torch.ones(nw, dtype=torch.bool)])
        return modes, (fill_mask if nw else None)

    parts = []
    if n_zp or n_wp:
        # dense bank: the perspective cuts, through the warp kernels
        modes, fill_mask = bank_modes(n_zp, n_wp)
        ms = torch.cat([zoom_ms[:n_zp], wide_ms[:n_wp]])
        parts.append(warp_batch_modes(work, ms, modes, cut_size, fill_value=fill_color,
                                      fill_mask=fill_mask))
    if n_zs or n_ws:
        # separable bank: the axis-aligned cuts, two matmuls each
        modes, fill_mask = bank_modes(n_zs, n_ws)
        ms = torch.cat([zoom_ms[n_zp:], wide_ms[n_wp:]])
        parts.append(warp_batch_separable(work, ms, modes, cut_size, fill_value=fill_color,
                                          fill_mask=fill_mask))
    batch = torch.cat(parts) if len(parts) > 1 else parts[0]
    if compute_dtype is not None:
        batch = batch.to(compute_dtype)

    r, g, b = batch[:, 0], batch[:, 1], batch[:, 2]
    if jitter is not None:
        r, g, b = random_color_jitter_planes(jitter, r, g, b)
    if noise is not None:
        facs, planes = noise
        r, g, b = (p + facs * z for p, z in zip((r, g, b), planes))
    return torch.stack([r, g, b], dim=1)


def draw_step_cutouts(gen_host, gen_device, cutn: int, cut_size: int, aspect: float, dtype, device):
    """All of one perceptor's per-step cutout draws, in the keys
    ``render_cutouts`` and ``cut_transforms`` take."""
    transforms = cut_transforms(draw_cut_params(gen_host, cutn, aspect), cut_size, aspect)
    jitter = draw_jitter_params(gen_host, cutn, hue=0.1, saturation=0.1, p=0.8)
    noise = draw_noise(gen_device, cutn, cut_size, dtype, device)
    return {"transforms": transforms, "jitter": jitter, "noise": noise}
