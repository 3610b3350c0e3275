"""Cutout geometry: 3x3 homographies built from explicit random draws.

Port of the transform builders in ``pixray_tpu/ops/warp.py``.  Matrices map
SOURCE pixel-centre coordinates to DESTINATION pixel-centre coordinates and
are composed, so each cutout is one bilinear resample.  Every builder is
vectorized over a leading bank dimension and takes its random draws as
tensors (already scaled to their ranges, as ``jax.random.uniform(minval,
maxval)`` returns them), so the same draws give the same matrices in both
packages.  The engine computes these on the host CPU, in exact float32.
"""

from __future__ import annotations

import math

import torch


def mm3(a, b):
    """Batched 3x3 product.  Exact float32 on the CPU (no TF32 there)."""
    return torch.matmul(a, b)


def inv3x3(m):
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _basis_to_quad(pts):
    """(..., 4, 2) points -> the 3x3 map sending the projective basis onto them."""
    q = torch.stack([pts[..., 0], pts[..., 1], torch.ones_like(pts[..., 0])], dim=-2)  # (..., 3, 4)
    big_q = q[..., :3]
    lam = torch.einsum("...ij,...j->...i", inv3x3(big_q), q[..., 3])
    return big_q * lam[..., None, :]


def homography_from_points(src_pts, dst_pts):
    """Homography mapping 4 src points to 4 dst points: A_dst · A_src⁻¹."""
    return mm3(_basis_to_quad(dst_pts), inv3x3(_basis_to_quad(src_pts)))


def random_perspective(h, w, distortion_scale, mags):
    """Inward 4-corner perspective.  mags: (..., 4, 2) uniforms in [0, 1)."""
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]])
    inward = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
    half = torch.tensor([w / 2.0, h / 2.0])
    dst = corners + inward * mags * distortion_scale * half
    return homography_from_points(corners.expand_as(dst), dst)


def crop_box_transform(x0, y0, cw, ch, out_h, out_w):
    """Affine mapping the source box [x0, x0+cw)×[y0, y0+ch) onto the output canvas."""
    sx = out_w / cw
    sy = out_h / ch
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    return torch.stack([
        torch.stack([sx, zero, -x0 * sx], dim=-1),
        torch.stack([zero, sy, -y0 * sy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def random_resized_crop(h, w, out_size, area_frac, log_ratio, ux, uy):
    """Area/aspect crop box resized to (out_size, out_size), as one affine.

    area_frac: uniform in the crop's area range; log_ratio: uniform in
    [log r0, log r1); ux, uy: uniforms in [0, 1) placing the box."""
    area = area_frac * (h * w)
    aspect = torch.exp(log_ratio)
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, float(h))
    x0 = ux * (w - cw)
    y0 = uy * (h - ch)
    return crop_box_transform(x0, y0, cw, ch, out_size, out_size)


def center_crop_transform(h, w, size):
    """Static centre-crop affine."""
    t = lambda v: torch.tensor(float(v))
    return crop_box_transform(t((w - size) / 2.0), t((h - size) / 2.0), t(size), t(size), size, size)


def random_affine(h, w, tx_frac, ty_frac, scale, degrees):
    """Affine about the image centre: scale, rotation by ``degrees`` and a
    translation of (tx_frac·w, ty_frac·h); each argument is a (...,) draw."""
    tx = tx_frac * w
    ty = ty_frac * h
    theta = degrees * (math.pi / 180.0)
    cos, sin = torch.cos(theta) * scale, torch.sin(theta) * scale
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    return torch.stack([
        torch.stack([cos, -sin, cx - cos * cx + sin * cy + tx], dim=-1),
        torch.stack([sin, cos, cy - sin * cx - cos * cy + ty], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
