"""Plain PyTorch cutout-bank warps.

``warp_modes_plain`` is the plain version of the CUDA warp kernels in
``ops/cuda_warp.py`` (same math as ``pixray_tpu/ops/warp_batch.py``'s
``warp_batch_modes``: the mode-selected gather plus the closed-form fill
composite): the CPU path of the engine (through ``cuda_warp.warp_batch_modes``),
the reference the kernels are compared with on the card, and what the CPU
tests hold against the JAX package.  Its gradient is autograd
through the 4-tap gather (a scatter-add), which equals the JAX package's
hat-matrix adjoint.

``warp_batch_separable`` renders axis-aligned cuts as two matmuls per cut, as
in the JAX package (no kernel there either).  Its matmuls run in float32.

Padding modes per cut: 0 reflection, 1 border, 2 zeros, 3 zeros composited
over ``fill`` by the closed-form bilinear coverage.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.ops.warp import inv3x3

MODE_REFLECT, MODE_BORDER, MODE_ZEROS, MODE_FILL = 0, 1, 2, 3


def _jnp_mod(x, y: float):
    """Floor modulo with ``jnp.mod``'s rounding (fmod, then shift into range)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def reflect_coord(x, size: int):
    """Reflect out-of-range coords about the pixel-edge boundaries (-0.5, size-0.5)."""
    span = 2.0 * size
    x = _jnp_mod(x + 0.5, span)
    x = torch.where(x >= size, span - x - 1e-6, x)
    return x - 0.5


def source_coords(inv, out_size: int):
    """Source coordinates of every output pixel: (N, S, S) sx, sy.

    inv: (N, 3, 3) inverse (dst→src) homographies.  Elementwise products (no
    matmul, so no TF32 on the card), with the kernels' ``+1e-8`` denominator."""
    idx = torch.arange(out_size, dtype=torch.float32, device=inv.device)
    ys = idx[:, None]
    xs = idx[None, :]
    m = inv[:, :, :, None, None]
    num_x = xs * m[:, 0, 0] + ys * m[:, 0, 1] + m[:, 0, 2]
    num_y = xs * m[:, 1, 0] + ys * m[:, 1, 1] + m[:, 1, 2]
    den = xs * m[:, 2, 0] + ys * m[:, 2, 1] + m[:, 2, 2]
    return num_x / (den + 1e-8), num_y / (den + 1e-8)


def _bilinear_zeros(work, x, y):
    """Bilinear sample of (H, W, C) at (N, S, S) coords; taps off the grid weigh 0.
    Returns (N, C, S, S)."""
    h, w, c = work.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    # coordinates far outside (or non-finite) contribute nothing
    x0i = x0.clamp(-2, w + 1).nan_to_num(-2).long()
    y0i = y0.clamp(-2, h + 1).nan_to_num(-2).long()
    flat = work.reshape(h * w, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[lin.reshape(-1)].reshape(*lin.shape, c).permute(0, 3, 1, 2)
        return torch.where(valid[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    return (
        tap(y0i, x0i) * (1 - wx) * (1 - wy)
        + tap(y0i, x0i + 1) * wx * (1 - wy)
        + tap(y0i + 1, x0i) * (1 - wx) * wy
        + tap(y0i + 1, x0i + 1) * wx * wy
    )


def warp_modes_plain(work, inv, modes, fill: float, out_size: int):
    """Mixed-mode bank warp: (H, W, C) f32, (N, 3, 3) inverse matrices, (N,)
    int modes, fill value → (N, C, S, S)."""
    h, w, _ = work.shape
    sx, sy = source_coords(inv, out_size)
    m = modes.to(sx.device)[:, None, None]
    tx = torch.where(m == MODE_REFLECT, reflect_coord(sx, w),
                     torch.where(m == MODE_BORDER, sx.clamp(0.0, w - 1.0), sx))
    ty = torch.where(m == MODE_REFLECT, reflect_coord(sy, h),
                     torch.where(m == MODE_BORDER, sy.clamp(0.0, h - 1.0), sy))
    out = _bilinear_zeros(work, tx, ty)
    # fill composite: coverage of the canvas at the RAW coords (closed form)
    cx = torch.clamp(torch.minimum(sx + 1.0, w - sx), 0.0, 1.0)
    cy = torch.clamp(torch.minimum(sy + 1.0, h - sy), 0.0, 1.0)
    fill_add = torch.where(m == MODE_FILL, (1.0 - cx * cy) * fill, torch.zeros_like(cx))
    return out + fill_add[:, None]


def modes_with_fill(modes, fill_mask):
    """Fold a fill mask into the per-cut modes (fill cuts become MODE_FILL)."""
    modes = modes.to(torch.int32)
    if fill_mask is None:
        return modes
    return torch.where(fill_mask.to(modes.device), torch.full_like(modes, MODE_FILL), modes)


def warp_batch_separable(work, matrices, modes, out_size: int, fill_value=0.0,
                         fill_mask=None):
    """Axis-aligned bank warp as two float32 matmuls per cut → (N, C, S, S).

    ``matrices`` must be axis-aligned src→dst, so the source coordinate of
    output pixel (i, j) factorizes as (sy(i), sx(j)) and the bilinear warp is
    exactly out[n] = Ay[n] @ work @ Bx[n]^T with 2-sparse hat operators."""
    h, w, _ = work.shape
    dev = work.device
    inv = inv3x3(matrices.float()).to(dev)
    idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    denom = inv[:, 2, 2, None] + 1e-8
    sx = (inv[:, 0, 0, None] * idx[None, :] + inv[:, 0, 2, None]) / denom  # (N, S)
    sy = (inv[:, 1, 1, None] * idx[None, :] + inv[:, 1, 2, None]) / denom
    m = modes.to(dev)[:, None]
    tx = torch.where(m == MODE_REFLECT, reflect_coord(sx, w),
                     torch.where(m == MODE_BORDER, sx.clamp(0.0, w - 1.0), sx))
    ty = torch.where(m == MODE_REFLECT, reflect_coord(sy, h),
                     torch.where(m == MODE_BORDER, sy.clamp(0.0, h - 1.0), sy))
    u = torch.arange(h, dtype=torch.float32, device=dev)
    v = torch.arange(w, dtype=torch.float32, device=dev)
    ay = torch.clamp(1.0 - torch.abs(ty[:, :, None] - u), min=0.0)  # (N, S, H)
    bx = torch.clamp(1.0 - torch.abs(tx[:, :, None] - v), min=0.0)  # (N, S, W)
    work_c = work.float().permute(2, 0, 1)  # (C, H, W)
    tmp = torch.einsum("niu,cuv->ncvi", ay, work_c)
    out = torch.einsum("ncvi,njv->ncij", tmp, bx)
    if fill_mask is not None:
        cx = torch.clamp(torch.minimum(sx + 1.0, w - sx), 0.0, 1.0)
        cy = torch.clamp(torch.minimum(sy + 1.0, h - sy), 0.0, 1.0)
        cover = (cy[:, :, None] * cx[:, None, :])[:, None]
        out = torch.where(fill_mask.to(dev)[:, None, None, None],
                          out + (1.0 - cover) * float(fill_value), out)
    return out
