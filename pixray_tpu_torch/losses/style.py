"""Style loss: STROTSS relaxed-EMD style transfer against a style image
(port of ``pixray_tpu/losses/style.py``).

- VGG16 hypercolumns (``models/vgg.py``) gathered bilinearly at sample
  points, with the coordinates halved at each downscaled map;
- the Laplacian pyramid, with JAX's ``jax.image.resize(..., "bilinear")``
  as ``F.interpolate(..., antialias=True)`` (antialiased when it shrinks;
  odd sizes halve as ``h // 2``);
- the content loss (pairwise cosine self-distances), the relaxed EMD, the
  moment loss and the palette REMD;
- the multi-scale loop over power-of-two downscalings with min side ≥ 33.

Draws.  The JAX loss draws inside the step from its key; here every draw
is an argument (``draws``, named per scale, see :func:`strotss_layout`):
five rounds of 2 × 1000 uniforms for the style samples, one pair of
offsets for the strided grid, and for iterations 1 and 2 a permutation of
the grid's rows and one of its columns.  The engine draws them on the host
after everything else a step draws and stages them with the step's inputs
(``StyleLoss.draw_layout``); tests feed the JAX package's draws.

The gate.  The JAX loss is ``lax.cond(it >= styleloss_skip and it %
styleloss_every == 0, ...)``.  Here the value is a ``torch.where`` on the
staged iteration, exactly 0 with a zero gradient when inactive; and the
engine leaves the loss out of a step, or of a whole block, in which the
gate is off at every step (``host_active``), so a run before
``styleloss_skip`` does not pay for it.

The style image's pyramid and its VGG maps are constants of the run: they
are made once per canvas size and device (under ``no_grad``), where the
JAX loss recomputes them in every step.  The distance and covariance
matrices are float32 (TF32 stays off, PyTorch's default); the tower runs
in the engine's model dtype (bf16 on the card under ``--precision bf16``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pixray_tpu_torch.losses.base import LossInterface
from pixray_tpu_torch.models.vgg import load_vgg16

FEAT_MAX = 3 + 2 * 64 + 2 * 128 + 3 * 256 + 2 * 512  # hypercolumn channels
SAMPLES, ROUNDS = 1000, 5  # style hypercolumn samples per round, rounds
ITERATIONS = 3  # loss evaluations per scale, the last two on permuted grids

_YUV = ((0.577350, 0.577350, 0.577350),
        (-0.577350, 0.788675, -0.211325),
        (-0.577350, -0.211325, 0.788675))


def _to_yuv(x):
    """``x @ _YUV.T`` for (P, 3) rows, with the matrix's entries as scalars
    (a host-made matrix would be a copy to the device, which a captured
    step may not make)."""
    return torch.stack([x[:, 0] * r[0] + x[:, 1] * r[1] + x[:, 2] * r[2] for r in _YUV], dim=1)


def _resize(x, hw):
    """(B, C, H, W) → (B, C, *hw): ``jax.image.resize(..., "bilinear")``
    (half-pixel centres, a triangle kernel widened when shrinking)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=True)


def laplacian(x):
    h, w = x.shape[2], x.shape[3]
    return x - _resize(_resize(x, (h // 2, w // 2)), (h, w))


def make_laplace_pyramid(x, levels):
    pyramid = []
    current = x
    for _ in range(levels):
        pyramid.append(laplacian(current))
        h, w = current.shape[2], current.shape[3]
        current = _resize(current, (max(h // 2, 1), max(w // 2, 1)))
    pyramid.append(current)
    return pyramid


def fold_laplace_pyramid(pyramid):
    current = pyramid[-1]
    for i in range(len(pyramid) - 2, -1, -1):
        current = pyramid[i] + _resize(current, (pyramid[i].shape[2], pyramid[i].shape[3]))
    return current


def _gather_hypercolumn(feats, xx, yy):
    """Bilinear samples of each captured map (B = 1) at the points (xx
    rows, yy columns) given in feats[0]'s coordinates, halved at each map
    smaller than the one before; → (P, channels + 2) float32, the points'
    coordinates last."""
    cols = []
    cur_xx, cur_yy = xx, yy
    prev_h = feats[0].shape[2]
    for i, f in enumerate(feats):
        if i > 0 and f.shape[2] < prev_h:
            cur_xx = cur_xx / 2.0
            cur_yy = cur_yy / 2.0
        prev_h = f.shape[2]
        c, h, w = f.shape[1], f.shape[2], f.shape[3]
        x0 = torch.floor(cur_xx)
        y0 = torch.floor(cur_yy)
        xr = (cur_xx - x0)[:, None]
        yr = (cur_yy - y0)[:, None]
        x0i = x0.long().clamp(0, h - 1)
        y0i = y0.long().clamp(0, w - 1)
        x1i = (x0i + 1).clamp(0, h - 1)
        y1i = (y0i + 1).clamp(0, w - 1)
        fm = f[0].permute(1, 2, 0).reshape(h * w, c)  # (H·W, C): a view of a channels_last map

        def at(r, q):  # in the points' dtype (float32; the maps may be bf16)
            return fm.index_select(0, r * w + q).to(xx.dtype)

        v = (
            at(x0i, y0i) * (1 - xr) * (1 - yr)
            + at(x0i, y1i) * (1 - xr) * yr
            + at(x1i, y0i) * xr * (1 - yr)
            + at(x1i, y1i) * xr * yr
        )
        cols.append(v)
    cols.append(xx[:, None])
    cols.append(yy[:, None])
    return torch.cat(cols, dim=1)


def pairwise_cos_dist(x, y):
    xn = torch.linalg.norm(x, dim=1, keepdim=True)
    yn = torch.linalg.norm(y, dim=1, keepdim=True)
    return 1.0 - (x @ y.T) / xn / yn.T


def pairwise_l2_dist(x, y):
    d = torch.sum(x**2, dim=1)[:, None] + torch.sum(y**2, dim=1)[None, :] - (2.0 * x) @ y.T
    return torch.sqrt(torch.minimum(torch.maximum(d, d.new_full((), 1e-5)), d.new_full((), 1e5)) / x.shape[1])


def content_loss(feat_result, feat_content):
    x = feat_result[:, :-2]
    y = feat_content[:, :-2]
    return torch.mean(torch.abs(pairwise_cos_dist(x, x) - pairwise_cos_dist(y, y)))


def remd_loss(x, y):
    """Relaxed earth mover's distance; on three channels (the palette) in
    YUV, cosine plus L2."""
    if x.shape[1] == 3:
        x, y = _to_yuv(x), _to_yuv(y)
        cx = pairwise_cos_dist(x, y) + pairwise_l2_dist(x, y)
    else:
        cx = pairwise_cos_dist(x, y)
    m1 = torch.amin(cx, dim=1)
    m2 = torch.amin(cx, dim=0)
    return torch.maximum(torch.mean(m1), torch.mean(m2))


def moments(y):
    """(mean (1, C), covariance (C, C)) of the rows of ``y``."""
    mu = torch.mean(y, dim=0, keepdim=True)
    yc = y - mu
    return mu, yc.T @ yc / (y.shape[0] - 1)


def moment_loss(x, y_moments):
    """Mean absolute gaps of the means and the covariances; the style's
    moments ``y_moments`` (:func:`moments`) are made once per scale."""
    mu_x, x_cov = moments(x)
    mu_y, y_cov = y_moments
    return torch.mean(torch.abs(mu_x - mu_y)) + torch.mean(torch.abs(x_cov - y_cov))


def strided_grid(h: int, w: int):
    """(stride_x, stride_y, nx, ny) of the sample grid over an (h, w) map."""
    const = 128**2
    big = h * w
    stride_x = max(int(np.floor(np.sqrt(big // const))), 1)
    stride_y = max(int(np.ceil(np.sqrt(big // const))), 1)
    return stride_x, stride_y, (h + stride_x - 1) // stride_x, (w + stride_y - 1) // stride_y


def _strided_indices(h, w, offsets, dtype=torch.float32):
    """The strided grid's points (rows, columns) in ``dtype``, its start
    offsets ``offsets`` (2,) (a device tensor) taken modulo the strides."""
    stride_x, stride_y, nx, ny = strided_grid(h, w)
    dev = offsets.device
    xs = torch.clamp(torch.remainder(offsets[0], stride_x) + stride_x * torch.arange(nx, device=dev), 0, h - 1)
    ys = torch.clamp(torch.remainder(offsets[1], stride_y) + stride_y * torch.arange(ny, device=dev), 0, w - 1)
    xx, yy = torch.meshgrid(xs, ys, indexing="ij")
    return xx.reshape(-1).to(dtype), yy.reshape(-1).to(dtype)


def calculate_loss(feat_result, feat_content, feat_style, style_moments, xx, yy, content_weight, moment_weight=1.0):
    n = min(1024, xx.shape[0])
    sr = _gather_hypercolumn(feat_result, xx[:n], yy[:n])
    sc = _gather_hypercolumn(feat_content, xx[:n], yy[:n])
    loss_c = content_loss(sr, sc)

    loss_remd = remd_loss(sr[:, :FEAT_MAX], feat_style[:, :FEAT_MAX])
    loss_moment = moment_loss(sr[:, :-2], style_moments)
    loss_moment = loss_moment + (1.0 / max(content_weight, 1.0)) * remd_loss(sr[:, :3], feat_style[:, :3])

    loss_style = loss_remd + moment_weight * loss_moment
    style_weight = 1.0 + moment_weight
    return (content_weight * loss_c + loss_style) / (content_weight + style_weight)


def sample_style_hypercolumn(feats, uniforms):
    """``ROUNDS`` rounds of ``SAMPLES`` bilinear hypercolumn samples of the
    style's maps ``feats`` at uniform points, ``uniforms`` (ROUNDS, 2,
    SAMPLES) in [0, 1) → (ROUNDS · SAMPLES, channels)."""
    h, w = feats[0].shape[2], feats[0].shape[3]
    chunks = [_gather_hypercolumn(feats, u[0] * (h - 1), u[1] * (w - 1))[:, :-2] for u in uniforms]
    return torch.cat(chunks, dim=0)


def strotss_scales(h: int, w: int) -> list[int]:
    """The divisors of the multi-scale loop, coarsest first: powers of two with min side ≥ 33."""
    return [2**s for s in range(9, -1, -1) if min(h, w) // 2**s >= 33]


@torch.no_grad()
def style_pyramid(vgg, style, h: int, w: int, space: str = "uniform"):
    """Per scale of an (h, w) canvas: (the style image's per-channel mean
    at that scale, its VGG maps).  ``style`` (1, 3, h, w) in [0, 1]."""
    out = []
    for scale in strotss_scales(h, w):
        style_s = _resize(style, (h // scale, w // scale))
        out.append((torch.mean(style_s, dim=(2, 3), keepdim=True), vgg(style_s, space)))
    return out


def strotss_layout(h: int, w: int) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of one step's draws on an (h, w) canvas, per
    scale ``si``: "si/uniforms" (ROUNDS, 2, SAMPLES) float32 in [0, 1),
    "si/offsets" (2,) int32 in [0, 2^30), "si/perms" (2, 2, P) int32:
    iteration 1 and 2's permutations of the grid's P rows and columns."""
    out = []
    for si, scale in enumerate(strotss_scales(h, w)):
        _sx, _sy, nx, ny = strided_grid(h // scale, w // scale)
        out += [(f"{si}/uniforms", (ROUNDS, 2, SAMPLES), torch.float32), (f"{si}/offsets", (2,), torch.int32),
                (f"{si}/perms", (ITERATIONS - 1, 2, nx * ny), torch.int32)]
    return out


def draw_strotss(gen: torch.Generator, h: int, w: int) -> dict:
    """One step's draws (:func:`strotss_layout`) from ``gen``."""
    out = {}
    for name, shape, _dtype in strotss_layout(h, w):
        kind = name.split("/")[1]
        if kind == "uniforms":
            out[name] = torch.rand(shape, generator=gen)
        elif kind == "offsets":
            out[name] = torch.randint(0, 2**30, shape, generator=gen, dtype=torch.int32)
        else:
            p = shape[-1]
            out[name] = torch.stack([torch.randperm(p, generator=gen, dtype=torch.int32)
                                     for _ in range(shape[0] * shape[1])]).view(shape)
    return out


def strotss_loss(out, style_scales, content_weight, vgg, draws, space="uniform"):
    """The multi-scale STROTSS loss of ``out`` (1, 3, H, W) float32 against
    the style's per-scale means and maps ``style_scales``
    (:func:`style_pyramid`), with one step's ``draws``
    (:func:`strotss_layout`)."""
    h, w = out.shape[2], out.shape[3]
    scales = strotss_scales(h, w)
    total = out.new_zeros(())
    lr = 2e-3
    result = None
    for si, scale in enumerate(scales):
        style_mean, style_feats = style_scales[si]
        content = _resize(out, (h // scale, w // scale))
        if si == 0:
            result = laplacian(content) + style_mean
        elif si == len(scales) - 1:
            result = _resize(result, (content.shape[2], content.shape[3]))
            lr = 1.0
        else:
            result = _resize(result, (content.shape[2], content.shape[3])) + laplacian(content)

        feat_content = vgg(content, space)
        feat_style = sample_style_hypercolumn(style_feats, draws[f"{si}/uniforms"])
        style_moments = moments(feat_style)
        stylized = fold_laplace_pyramid(make_laplace_pyramid(result, 5))
        feat_result = vgg(stylized, space)

        xx, yy = _strided_indices(content.shape[2], content.shape[3], draws[f"{si}/offsets"], out.dtype)
        for it in range(ITERATIONS):
            if it != 0:
                perm = draws[f"{si}/perms"][it - 1].long()
                xx, yy = xx.index_select(0, perm[0]), yy.index_select(0, perm[1])
            total = total + calculate_loss(feat_result, feat_content, feat_style, style_moments, xx, yy,
                                           content_weight) * lr
        content_weight /= 2.0
    return total


class StyleLoss(LossInterface):
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--style_file", type=str, default="", dest="style_file")
        parser.add_argument("--styleloss_content_weight", type=float, default=32, dest="styleloss_content_weight")
        parser.add_argument("--styleloss_ospace", type=str, default="uniform", dest="styleloss_ospace")
        parser.add_argument("--styleloss_skip", type=int, default=100, dest="styleloss_skip")
        parser.add_argument("--styleloss_every", type=int, default=1, dest="styleloss_every")
        return parser

    def __init__(self, settings=None):
        super().__init__(settings)
        self.vgg = None
        self.style_pil = None
        self._pyramids = {}
        if settings.style_file:
            from pixray_tpu_torch.io.images import open_images

            self.style_pil = open_images(settings.style_file)[0].convert("RGB")

    def place(self, device, dtype, state_dict=None):
        """The tower, frozen, on the engine's device in its model dtype
        (``state_dict``: torchvision names; else the weight files, else random)."""
        self.vgg = load_vgg16(device, dtype, state_dict)
        self._pyramids = {}

    def host_active(self, it: int) -> bool:
        args = self.settings
        return self.style_pil is not None and it >= args.styleloss_skip and it % args.styleloss_every == 0

    def draw_layout(self, h: int, w: int):
        return [] if self.style_pil is None else strotss_layout(h, w)

    def draw(self, gen, h: int, w: int) -> dict:
        return {} if self.style_pil is None else draw_strotss(gen, h, w)

    def _style_scales(self, h, w, device, dtype):
        key = (h, w, str(device), dtype)
        if key not in self._pyramids:
            from pixray_tpu_torch.io.images import resize_bicubic

            style = torch.from_numpy(resize_bicubic(self.style_pil, (w, h))).permute(2, 0, 1)[None].to(device, dtype)
            self._pyramids[key] = style_pyramid(self.vgg, style, h, w, self.settings.styleloss_ospace)
        return self._pyramids[key]

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        if self.style_pil is None:
            return out.new_zeros(())
        h, w = out.shape[0], out.shape[1]
        # the canvas as the JAX loss takes it: [0, 1] straight into the
        # 'uniform'-space extractor, no remap
        x = out.permute(2, 0, 1)[None]
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        total = strotss_loss(x, self._style_scales(h, w, x.device, x.dtype), args.styleloss_content_weight,
                             self.vgg, globals["draws"], space=args.styleloss_ospace)
        it = globals["cur_iteration"]
        active = (it >= args.styleloss_skip) & (torch.remainder(it, args.styleloss_every) == 0)
        return torch.where(active, total, total.new_zeros(()))


def _resize_long_edge(pil, trg):
    """The long edge resized to ``trg`` (bicubic)."""
    from PIL import Image

    short_w = pil.width < pil.height
    ar_resized_long = (trg / pil.height) if short_w else (trg / pil.width)
    return pil.resize((int(pil.width * ar_resized_long), int(pil.height * ar_resized_long)), Image.BICUBIC)


def run_strotss(content_pil, style_pil, content_weight=16.0, space="uniform", steps=150, seed=0, progress=print,
                device="cuda"):
    """Standalone STROTSS style transfer: Adam (lr 0.02) on a
    sigmoid-parameterized canvas that starts at the content image, one
    value and gradient of :func:`strotss_loss` per step with fresh draws.
    Returns a (H, W, 3) float32 array in [0, 1]."""
    from pixray_tpu_torch.engine.optimizers import Adam

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not available")
    content = torch.from_numpy(np.asarray(content_pil, np.float32) / 255.0).permute(2, 0, 1)[None].to(device)
    h, w = content.shape[2], content.shape[3]
    style = torch.from_numpy(np.asarray(style_pil.resize((w, h)), np.float32) / 255.0).permute(2, 0, 1)[None]
    vgg = load_vgg16(device, torch.float32)
    style_scales = style_pyramid(vgg, style.to(device), h, w, space)

    img0 = content.clamp(1e-3, 1 - 1e-3)
    z = torch.log(img0 / (1 - img0))  # sigmoid logits, init = content
    opt = Adam(0.02)
    state = opt.init(z)
    gen = torch.Generator().manual_seed(seed)
    for it in range(steps):
        draws = {k: v.to(device) for k, v in draw_strotss(gen, h, w).items()}
        zp = z.detach().requires_grad_(True)
        loss = strotss_loss(torch.sigmoid(zp), style_scales, content_weight, vgg, draws, space)
        (g,) = torch.autograd.grad(loss, zp)
        with torch.no_grad():
            updates, state = opt.update(g, state)
            z = z + updates
        if it % 25 == 0 or it == steps - 1:
            progress(f"strotss step {it}: loss {float(loss):.4f}")
    return torch.sigmoid(z[0]).permute(1, 2, 0).cpu().numpy()


def main(argv=None):
    """``python -m pixray_tpu_torch.losses.style content.png style.png``:
    STROTSS on the card (``--device cpu`` for the CPU)."""
    import argparse

    from PIL import Image

    parser = argparse.ArgumentParser(description="STROTSS style transfer")
    parser.add_argument("content", type=str)
    parser.add_argument("style", type=str)
    parser.add_argument("--weight", type=float, default=1.0)
    parser.add_argument("--output", type=str, default="strotss.png")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--ospace", type=str, default="uniform", choices=["uniform", "vgg"])
    parser.add_argument("--resize_to", type=int, default=512)
    parser.add_argument("--steps", type=int, default=150)
    args = parser.parse_args(argv)

    if args.resize_to < 2**8:
        print("Resulution too low.")  # sic: the reference's message
        raise SystemExit(1)

    content_pil = Image.open(args.content).convert("RGB")
    style_pil = Image.open(args.style).convert("RGB")
    result = run_strotss(
        _resize_long_edge(content_pil, args.resize_to),
        _resize_long_edge(style_pil, args.resize_to),
        content_weight=args.weight * 16.0,
        space=args.ospace,
        steps=args.steps,
        device=args.device,
    )
    Image.fromarray((result * 255).astype(np.uint8)).save(args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
