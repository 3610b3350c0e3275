"""Cutout pipeline: pooling, cut geometry and the cutout bank (port of ``pixray_tpu/engine/cutouts.py``).

The path ported is the JAX package's default one:

- the canvas is avg+max pooled once to a SQUARE working canvas of the
  perceptor's resolution, and the aspect re-widening is folded into every
  cut matrix (``work_from_pooled_matrix``);
- 60% "zoom" cuts (random perspective ∘ random resized crop), padded by
  reflection or border on alternate iterations, and 40% "wide" cuts (random
  affine ∘ centre crop ∘ perspective) composited over a random gray;
- a FIXED count of perspective cuts per branch (``persp_split``), which
  fixes the bank's row order (``bank_order``);
- a channel-major (N, 3, S, S) bank with hue/saturation jitter and
  additive noise per channel plane: on the card one K1 launch makes it
  and one K2 launch takes its gradient (``ops/cuda_warp.py``), every cut
  alike; on the CPU the plain composition;
- the banks that reuse a step's cuts without jitter, each with its own
  noise: the spot and spot_off banks (the masked work canvas) and one
  bank per image prompt (its own cuts under ``--image_prompt_shuffle``);
  ``draw_step_cutouts`` draws them after the main bank, ``draw_banks``
  lists a perceptor's banks in row order.

Random draws are explicit: the cut geometry, jitter parameters and noise
factors come from a CPU ``torch.Generator`` (they are tiny and travel to the
card in one block of parameter rows, :func:`pack_cutouts`), the noise
planes from a generator on the canvas's device (drawn into given planes
when a block of steps keeps them at fixed addresses).  Every
function that draws also accepts the draws, so tests feed the JAX
package's own draws.
"""

from __future__ import annotations

import math

import torch

from pixray_tpu_torch.ops import warp as W
from pixray_tpu_torch.ops.color import draw_jitter_params
from pixray_tpu_torch.ops.cuda_warp import cutout_bank, pack_params
from pixray_tpu_torch.ops.pool import adaptive_avg_pool, adaptive_max_pool
from pixray_tpu_torch.ops.warp_batch import MODE_BORDER, MODE_FILL, MODE_REFLECT

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


def draw_noise(gen_host, gen_device, n: int, cut_size: int, dtype, device, out=None):
    """Per-cut noise factors (N, 1, 1) on the host and three (N, S, S)
    gaussian planes on ``device``, both in ``dtype``.  ``out``: three (N, S,
    S) planes to draw into (the same numbers as new ones)."""
    facs = (torch.rand((n, 1, 1), generator=gen_host) * NOISE_FAC).to(dtype)
    if out is None:
        planes = [torch.randn((n, cut_size, cut_size), generator=gen_device, device=device, dtype=dtype)
                  for _ in range(3)]
    else:
        planes = [torch.randn((n, cut_size, cut_size), generator=gen_device, out=z) for z in out]
    return facs, planes


def bank_order(n_zoom: int, n_wide: int):
    """Row order of the bank as indices into cat([zoom, wide]): the
    perspective zoom cuts, the perspective wide cuts, then the axis-aligned
    zoom and wide cuts (the JAX bank's order, ``persp_split`` per branch)."""
    n_zp, _ = persp_split(n_zoom)
    n_wp, _ = persp_split(n_wide)
    zoom = torch.arange(n_zoom)
    wide = n_zoom + torch.arange(n_wide)
    return torch.cat([zoom[:n_zp], wide[:n_wp], zoom[n_zp:], wide[n_wp:]])


def pack_cutouts(transforms, *, reflect_padding: bool, fill_color: float, jitter=None, facs=None, out=None):
    """The (N, PARAM_STRIDE) host parameter rows of one bank, in bank order
    (see :func:`render_cutouts` for the arguments; ``facs`` (N, 1, 1)).
    ``out``: the host rows to write, else new ones."""
    zoom_ms, wide_ms = transforms
    nz, nw = zoom_ms.shape[0], wide_ms.shape[0]
    order = bank_order(nz, nw)
    ms = torch.cat([zoom_ms, wide_ms])[order]
    modes = torch.cat([torch.full((nz,), MODE_REFLECT if reflect_padding else MODE_BORDER),
                       torch.full((nw,), MODE_FILL)])[order]
    return pack_params(W.inv3x3(ms.float()), modes, jitter, facs, fill=fill_color, out=out)


def render_cutouts(work, transforms, cut_size: int, *, reflect_padding: bool,
                   fill_color: float, jitter=None, noise=None, compute_dtype=None,
                   prec: str = "highest", bwd: str | None = None):
    """The (N, 3, S, S) cutout bank from the working canvas.

    transforms: (zoom, wide) matrices from ``cut_transforms``.
    reflect_padding: zoom cuts pad by reflection (True) or border (False).
    fill_color: the wide cuts' gray.
    jitter: (hue_shift, sat_factor, apply) per bank row, or None for no jitter.
    noise: (facs (N, 1, 1), [3 planes (N, S, S)]) per bank row, or None.
    compute_dtype: dtype of the bank and its epilogue (None = float32).
    prec, bwd: K1's and K2's precision rungs (``config/precision.py``;
    ``bwd`` None: ``norm_prec(prec)``).

    Every cut, perspective or axis-aligned, goes through one bank warp
    (``cuda_warp.cutout_bank``, which the step calls on the rows of
    :func:`pack_cutouts`): on the card K1/K2 with the epilogue inside, on
    the CPU the plain composition."""
    facs, planes = (None, None) if noise is None else noise
    params = pack_cutouts(transforms, reflect_padding=reflect_padding, fill_color=fill_color,
                          jitter=jitter, facs=facs)
    return cutout_bank(work, params, cut_size, planes, compute_dtype, prec, bwd)


def draw_step_cutouts(gen_host, gen_device, cutn: int, cut_size: int, aspect: float, dtype, device,
                      planes_out=None, spot=False, spot_off=False, image_prompts=0, shuffle=False):
    """All of one perceptor's per-step cutout draws: the main bank's
    ``transforms``, ``jitter`` and ``noise`` (the keys ``render_cutouts``
    takes), then those of the banks that reuse its geometry without jitter,
    in this order: ``spot`` noise (when ``spot``), ``spot_off`` noise (when
    ``spot_off``), and per image prompt a dict of ``transforms`` (fresh
    geometry under ``shuffle``, else None: the main bank's) and ``noise``.
    A perceptor without those banks draws exactly the main bank's stream.
    ``planes_out``: three (banks * cutn, S, S) planes, bank after bank in
    that order, that the noise planes are drawn into."""
    planes = None if planes_out is None else [[z[k * cutn:(k + 1) * cutn] for z in planes_out]
                                               for k in range(1 + spot + spot_off + image_prompts)]
    banks = iter(planes or [])

    def noise():
        return draw_noise(gen_host, gen_device, cutn, cut_size, dtype, device, out=next(banks, None))

    transforms = cut_transforms(draw_cut_params(gen_host, cutn, aspect), cut_size, aspect)
    jitter = draw_jitter_params(gen_host, cutn, hue=0.1, saturation=0.1, p=0.8)
    out = {"transforms": transforms, "jitter": jitter, "noise": noise()}
    if spot:
        out["spot"] = noise()
    if spot_off:
        out["spot_off"] = noise()
    if image_prompts:
        out["image_prompts"] = []
        for _ in range(image_prompts):
            t = cut_transforms(draw_cut_params(gen_host, cutn, aspect), cut_size, aspect) if shuffle else None
            out["image_prompts"].append({"transforms": t, "noise": noise()})
    return out


def draw_banks(draws):
    """A perceptor's banks in row order, as (transforms, jitter, noise):
    the main bank, then spot, spot_off and each image prompt (without
    jitter, on the main bank's geometry unless the prompt drew its own)."""
    main = draws["transforms"]
    out = [(main, draws["jitter"], draws["noise"])]
    out += [(main, None, draws[k]) for k in ("spot", "spot_off") if k in draws]
    out += [(ip["transforms"] if ip["transforms"] is not None else main, None, ip["noise"])
            for ip in draws.get("image_prompts", [])]
    return out
