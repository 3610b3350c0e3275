"""Line-sketch drawer: long fixed-black strokes on a paper-colored background
(port of ``pixray_tpu/drawers/line_sketch.py``).

``--strokes`` paths of ``--stroke_length`` cubic segments (P = 8 *
stroke_length + 1 polyline samples), centered random-walk init, paper color
#f2eecb (trainable under ``--allow_paper_color``, the one path on which the
stroke backward's background gradient reaches a parameter), widths clamped
to [1, max], per-group Adam LRs (points 1.0, widths 0.1, paper 0.01).
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.drawers.clipdraw import latent_from_numpy, numpy_latent, path_d, svg_header
from pixray_tpu_torch.engine.optimizers import PerGroupAdam
from pixray_tpu_torch.ops.cuda_strokes import render_strokes_auto
from pixray_tpu_torch.ops.strokes import bezier_basis, clip_like_jnp
from pixray_tpu_torch.utils import str2bool

PAPER_COLOR = (242 / 255.0, 238 / 255.0, 203 / 255.0)


class LineDrawer:
    has_alpha = False

    @staticmethod
    def add_settings(parser):
        parser.add_argument("--strokes", type=int, help="number strokes", default=24, dest="strokes")
        parser.add_argument("--stroke_length", type=int, help="stroke length", default=8, dest="stroke_length")
        parser.add_argument("--min_stroke_width", type=float, help="min width (percent of height)", default=0.5, dest="min_stroke_width")
        parser.add_argument("--max_stroke_width", type=float, help="max width (percent of height)", default=2, dest="max_stroke_width")
        parser.add_argument("--allow_paper_color", type=str2bool, help="allow paper color to change", default=False, dest="allow_paper_color")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.num_paths = settings.strokes
        self.stroke_length = settings.stroke_length
        self.max_width = settings.max_stroke_width * self.canvas_height / 100
        self.min_width = settings.min_stroke_width * self.canvas_height / 100
        self.allow_paper_color = settings.allow_paper_color
        self.model_params = {}

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        return self.canvas_width, self.canvas_height

    def _init_strokes(self, rng: np.random.Generator):
        """Centered random-walk init (linedrawer.py:76-95)."""
        n = self.num_paths
        segs = self.stroke_length
        v = 1 + 3 * segs
        pts = np.zeros((n, v, 2), dtype=np.float32)
        for i in range(n):
            radius = 0.5
            radius_x = 0.5
            p0 = np.array([0.5 + radius_x * (rng.random() - 0.5), 0.5 + radius * (rng.random() - 0.5)])
            pts[i, 0] = p0
            idx = 1
            for _ in range(segs):
                radius = 1.0 / (segs + 2)
                radius_x = radius * self.canvas_height / self.canvas_width
                for _ in range(3):
                    p0 = p0 + np.array([radius_x, radius]) * (np.array([rng.random(), rng.random()]) - 0.5)
                    pts[i, idx] = p0
                    idx += 1
                p0 = np.clip(p0, 0, 1)
        pts[:, :, 0] *= self.canvas_width
        pts[:, :, 1] *= self.canvas_height
        return pts

    def init_params(self, gen, init_tensor=None):
        """Random walks from a numpy generator seeded by ``gen``;
        ``init_tensor`` is accepted and ignored, as in the JAX drawer."""
        rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (), generator=gen)))
        pts = self._init_strokes(rng)
        self.model_params = {
            "basis": bezier_basis([self.stroke_length] * self.num_paths, self.stroke_length)
        }
        z = {"points": pts, "widths": np.full((self.num_paths,), self.max_width / 10.0)}
        if self.allow_paper_color:
            z["paper"] = np.asarray(PAPER_COLOR)
        return latent_from_numpy(z, {})[0]

    def params_from_image(self, image_tensor):
        raise NotImplementedError("line_sketch cannot re-encode images")

    def clip_params(self, z):
        out = {
            "points": z["points"],
            "widths": clip_like_jnp(z["widths"], 1.0, self.max_width),
        }
        if "paper" in z:
            out["paper"] = clip_like_jnp(z["paper"], 0.0, 1.0)
        return out

    def get_opts(self, args, decay_divisor: float):
        lrs = {"points": 1.0 / decay_divisor, "widths": 0.1 / decay_divisor}
        if self.allow_paper_color:
            lrs["paper"] = 0.01 / decay_divisor
        return PerGroupAdam(lrs)

    def _paper(self, z):
        if "paper" in z:
            return z["paper"]
        # filled on the device (no copy from the host, so a CUDA graph can capture it)
        return torch.stack([z["points"].new_full((), c) for c in PAPER_COLOR])

    def synth(self, model_params, z, iteration=None):
        bg = self._paper(z).expand(self.canvas_height, self.canvas_width, 3)
        colors = torch.cat([z["points"].new_zeros((self.num_paths, 3)), z["points"].new_ones((self.num_paths, 1))], 1)
        out = render_strokes_auto(z["points"], z["widths"], colors, model_params["basis"],
                                  self.canvas_height, self.canvas_width, bg)
        return out[..., :3]

    def to_svg(self, z) -> str:
        paper = self._paper(z).detach().cpu().numpy()
        z = numpy_latent(z)
        pts, widths = z["points"], z["widths"]
        r, g, b = (np.clip(paper, 0, 1) * 255).astype(int)
        parts = [
            svg_header(self.canvas_width, self.canvas_height),
            f'<rect width="{self.canvas_width}" height="{self.canvas_height}" fill="rgb({r},{g},{b})"/>',
        ]
        for i in range(pts.shape[0]):
            parts.append(
                f'<path d="{path_d(pts, i, self.stroke_length)}" fill="none" stroke="black" '
                f'stroke-width="{widths[i]:.2f}"/>'
            )
        parts.append("</svg>")
        return "\n".join(parts)
