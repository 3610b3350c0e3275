"""ClipDraw drawer: up to 1024 trainable Bézier strokes (port of ``pixray_tpu/drawers/clipdraw.py``).

Random 1-3-segment cubic curves; trainable points, widths and RGBA stroke
colors with per-group Adam LRs 1.0 / 0.1 / 0.01; composited over white;
widths and colors clamped after each step.  Rendering goes through the
stroke rasterizer (``ops/cuda_strokes.py``: CUDA kernels on the card, the
plain version on the CPU).

The latent is ``{"points": (N, V, 2), "widths": (N,), "colors": (N, 4)}``
and ``model_params = {"basis": (N, P, V)}``.  The JAX drawer seeds its numpy
generator from ``jax.random.randint``, which torch cannot reproduce: to run
from the JAX drawer's latent, carry it across with :func:`latent_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.engine.optimizers import PerGroupAdam
from pixray_tpu_torch.ops.cuda_strokes import render_strokes_auto
from pixray_tpu_torch.ops.strokes import bezier_basis, clip_like_jnp

MAX_SEGMENTS = 3


def latent_from_numpy(z: dict, model_params: dict, device="cpu"):
    """The JAX drawer's latent and ``model_params`` (numpy arrays) → the
    port's (latent, model_params) as float32 tensors on ``device``."""
    to = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return {k: to(v) for k, v in z.items()}, {k: to(v) for k, v in model_params.items()}


def numpy_latent(z: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in z.items()}


def path_d(pts, i: int, segments: int) -> str:
    """SVG path data of stroke i: a move and ``segments`` cubic curves."""
    d = f"M {pts[i, 0, 0]:.2f},{pts[i, 0, 1]:.2f} "
    for s in range(segments):
        c = pts[i, 1 + 3 * s : 4 + 3 * s]
        d += (
            f"C {c[0, 0]:.2f},{c[0, 1]:.2f} {c[1, 0]:.2f},{c[1, 1]:.2f} "
            f"{c[2, 0]:.2f},{c[2, 1]:.2f} "
        )
    return d


def svg_header(width: int, height: int) -> str:
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}">')


class ClipDrawer:
    has_alpha = False

    @staticmethod
    def add_settings(parser):
        parser.add_argument("--strokes", type=int, help="number strokes", default=1024, dest="strokes")
        parser.add_argument("--min_stroke_width", type=float, help="min width (percent of height)", default=1, dest="min_stroke_width")
        parser.add_argument("--max_stroke_width", type=float, help="max width (percent of height)", default=5, dest="max_stroke_width")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.num_paths = settings.strokes
        self.max_width = settings.max_stroke_width * self.canvas_height / 100
        self.min_width = settings.min_stroke_width * self.canvas_height / 100
        self.model_params = {}

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        return self.canvas_width, self.canvas_height

    def _init_strokes(self, rng: np.random.Generator):
        """Random curve init (clipdrawer.py:47-71): 1-3 segments, 0.1-radius walk."""
        n = self.num_paths
        seg_counts = rng.integers(1, MAX_SEGMENTS + 1, size=n)
        v = 1 + 3 * MAX_SEGMENTS
        pts = np.zeros((n, v, 2), dtype=np.float32)
        for i in range(n):
            p0 = np.array([rng.random(), rng.random()])
            pts[i, 0] = p0
            radius = 0.1
            idx = 1
            for _ in range(seg_counts[i]):
                for _ in range(3):
                    p0 = p0 + radius * (np.array([rng.random(), rng.random()]) - 0.5)
                    pts[i, idx] = p0
                    idx += 1
            # pad remaining control points at the endpoint (degenerate tail)
            while idx < v:
                pts[i, idx] = p0
                idx += 1
        pts[:, :, 0] *= self.canvas_width
        pts[:, :, 1] *= self.canvas_height
        return seg_counts, pts

    def init_params(self, gen, init_tensor=None):
        """Random strokes from a numpy generator seeded by ``gen``;
        ``init_tensor`` is accepted and ignored, as in the JAX drawer."""
        rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (), generator=gen)))
        seg_counts, pts = self._init_strokes(rng)
        self.model_params = {"basis": bezier_basis(seg_counts, MAX_SEGMENTS)}
        widths = np.full((self.num_paths,), (self.min_width + self.max_width) / 4, np.float32)
        colors = rng.random((self.num_paths, 4)).astype(np.float32)
        return latent_from_numpy({"points": pts, "widths": widths, "colors": colors}, {})[0]

    def params_from_image(self, image_tensor):
        raise NotImplementedError("clipdraw cannot re-encode images")

    def clip_params(self, z):
        return {
            "points": z["points"],
            "widths": clip_like_jnp(z["widths"], self.min_width, self.max_width),
            "colors": clip_like_jnp(z["colors"], 0.0, 1.0),
        }

    def get_opts(self, args, decay_divisor: float):
        """Per-group Adam LRs (clipdrawer.py:102-108)."""
        return PerGroupAdam({"points": 1.0 / decay_divisor, "widths": 0.1 / decay_divisor,
                             "colors": 0.01 / decay_divisor})

    def synth(self, model_params, z, iteration=None):
        bg = torch.ones((self.canvas_height, self.canvas_width, 3), device=z["points"].device)
        out = render_strokes_auto(z["points"], z["widths"], z["colors"], model_params["basis"],
                                  self.canvas_height, self.canvas_width, bg)
        # composite over white (clipdrawer.py:133-134) → opaque RGB
        return out[..., :3]

    def to_svg(self, z) -> str:
        z = numpy_latent(z)
        pts, widths, colors = z["points"], z["widths"], z["colors"]
        parts = [svg_header(self.canvas_width, self.canvas_height)]
        for i in range(pts.shape[0]):
            r, g, b = (np.clip(colors[i, :3], 0, 1) * 255).astype(int)
            a = float(np.clip(colors[i, 3], 0, 1))
            parts.append(
                f'<path d="{path_d(pts, i, MAX_SEGMENTS)}" fill="none" stroke="rgb({r},{g},{b})" '
                f'stroke-opacity="{a:.3f}" stroke-width="{widths[i]:.2f}"/>'
            )
        parts.append("</svg>")
        return "\n".join(parts)
