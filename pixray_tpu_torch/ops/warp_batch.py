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

Precision rungs (``prec``; ``pixray_tpu/ops/pallas_warp.py`` ``_mm``, ``_mm_nt``
and the int8 branches of ``_fwd_kernel_multi_T`` / ``_bwd_kernel_multi_TB``):
"highest" is the exact warp above; the others are the plain versions of
K1's and K2's rung variants, in tap form with the JAX hats
``max(0, 1 - |t - u|)`` of the two taps per axis:

- forward "bf16": per x tap, sum over the y taps of bf16(work) * bf16(hat_y)
  in float32, then sum over the x taps of that times hat_x, plus the fill;
  "high": the same from the hi/lo bf16 split of both factors, three products
  (hi.hi, lo.hi, hi.lo) summed in that order; the kernels read the
  canvas's splits from a pack pass (:func:`pack_bf16_texels`);
- forward "int8": the canvas quantized per tensor (:func:`quantize_canvas`),
  the y hats as round(hat * 127), integer sums per x tap, then float32 times
  hat_x plus the fill divided by the dequant scale, times that scale
  ``s_w / 127^2``;
- adjoint "bf16" / "high": per tap bf16(hat_y) * bf16(hat_x * g) (or its
  hi/lo form) summed into the canvas; "int8": the cotangent over its
  absolute maximum ``s_g``, round(hat_y * g' * 127) * round(hat_x * 127)
  summed exactly in int64, then times ``s_g / 127^2``.

Each adjoint is the straight-through adjoint of the exact warp (not of the
quantized forward), as the JAX package's custom VJP has it.
:func:`norm_prec` and :func:`bwd_prec` say which rung K2 runs for K1's.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.ops.warp import inv3x3

MODE_REFLECT, MODE_BORDER, MODE_ZEROS, MODE_FILL = 0, 1, 2, 3
WARP_PRECS = ("int8", "bf16", "high", "highest")
BWD_BAND_ROWS = 64 + 16  # the JAX banded backward's 64-row band needs this many canvas rows
Q127 = 127.0
DEQUANT = 127.0 * 127.0


def norm_prec(prec: str) -> str:
    """int8 exists only on K1; every other warp kernel runs it as bf16."""
    return "bf16" if prec == "int8" else prec


def bwd_prec(prec: str, warp_bwd: str, canvas_rows: int) -> str:
    """K2's rung for K1's ``prec``: int8 only with an int8 forward,
    ``warp_bwd == "int8"`` (``PIXRAY_TPU_WARP_BWD_PREC``) and a canvas of
    at least ``BWD_BAND_ROWS`` rows (where the JAX package's banded
    backward, which holds its int8 branch, runs); else :func:`norm_prec`."""
    if prec == "int8" and warp_bwd == "int8" and canvas_rows >= BWD_BAND_ROWS:
        return "int8"
    return norm_prec(prec)


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
        # index_select: its gradient (index_add_) sums the taps in one order on
        # the CPU, where indexing's (index_put_) parts by thread above its grain
        vals = flat.index_select(0, lin.reshape(-1)).reshape(*lin.shape, c).permute(0, 3, 1, 2)
        return torch.where(valid[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    return (
        tap(y0i, x0i) * (1 - wx) * (1 - wy)
        + tap(y0i, x0i + 1) * wx * (1 - wy)
        + tap(y0i + 1, x0i) * (1 - wx) * wy
        + tap(y0i + 1, x0i + 1) * wx * wy
    )


def warp_modes_plain(work, inv, modes, fill, out_size: int):
    """Mixed-mode bank warp: (H, W, C) f32, (N, 3, 3) inverse matrices, (N,)
    int modes, the fill value (a float, or (N,) float32 per cut) → (N, C, S, S)."""
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
    if torch.is_tensor(fill):
        fill = fill[:, None, None]
    fill_add = torch.where(m == MODE_FILL, (1.0 - cx * cy) * fill, torch.zeros_like(cx))
    return out + fill_add[:, None]


def _bf(x):
    """x rounded to bf16, kept in float32."""
    return x.to(torch.bfloat16).float()


def _lo(x):
    """The bf16 low part of x: bf16(x - bf16(x))."""
    return _bf(x - _bf(x))


def quantize_canvas(work):
    """K1-int8's canvas: ``s_w = max(max|work|, 1e-6)`` (a () float32
    tensor on the canvas's device, no host read) and ``round(work / s_w * 127)``
    as int8, in that order."""
    s_w = torch.clamp(work.abs().amax(), min=1e-6)
    return torch.round(work / s_w * Q127).to(torch.int8), s_w


def pack_texels(codes):
    """(..., 3) int8 codes → (...) int32 texels as K1-int8's pack pass
    writes them: r, g, b in bytes 0, 1, 2 (two's complement), byte 3 zero."""
    b = codes.to(torch.int32) & 0xFF
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


def pack_bf16_texels(work, prec: str):
    """(H, W, 3) float32 canvas → the texels of K1-bf16's and K1-high's
    pack pass, bf16: (H, W, 4) ``bf16(r), bf16(g), bf16(b), 0`` for
    "bf16"; (H, W, 8) for "high", those three, then the low parts
    ``bf16(x - bf16(x))`` of each channel, then two zeros (``_mm``'s
    ``a_hi`` and ``a_lo``)."""
    hi = work.to(torch.bfloat16)
    planes = [hi]
    if prec == "high":
        planes.append((work - hi.float()).to(torch.bfloat16))
    elif prec != "bf16":
        raise ValueError(f"pack_bf16_texels takes bf16 or high; got {prec!r}")
    planes.append(torch.zeros((*work.shape[:-1], 1 if prec == "bf16" else 2), dtype=torch.bfloat16,
                              device=work.device))
    return torch.cat(planes, dim=-1)


def _dequant_scale(s):
    """``s / 127^2`` as a true division (PyTorch's CUDA division by a
    Python scalar is a product with its reciprocal; the kernels divide)."""
    return s / torch.full_like(s, DEQUANT)


def _rung_taps(work_shape, inv, modes, fill, out_size):
    """The four taps of every output pixel with the JAX hats: flat canvas
    pixel indices (4, N, S, S), their validity, the x hats (2, N, S, S),
    the y hats, and the fill term before any scale (N, 1, S, S)."""
    h, w, _ = work_shape
    sx, sy = source_coords(inv, out_size)
    m = modes.to(sx.device)[:, None, None]
    tx = torch.where(m == MODE_REFLECT, reflect_coord(sx, w),
                     torch.where(m == MODE_BORDER, sx.clamp(0.0, w - 1.0), sx))
    ty = torch.where(m == MODE_REFLECT, reflect_coord(sy, h),
                     torch.where(m == MODE_BORDER, sy.clamp(0.0, h - 1.0), sy))
    x0, y0 = torch.floor(tx), torch.floor(ty)
    hat = lambda t, u: torch.clamp(1.0 - torch.abs(t - u), min=0.0)
    hx = torch.stack([hat(tx, x0), hat(tx, x0 + 1.0)])
    hy = torch.stack([hat(ty, y0), hat(ty, y0 + 1.0)])
    x0i = x0.clamp(-2, w + 1).nan_to_num(-2).long()
    y0i = y0.clamp(-2, h + 1).nan_to_num(-2).long()
    idx, valid = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0i + dy, x0i + dx
            valid.append((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))
            idx.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
    cx = torch.clamp(torch.minimum(sx + 1.0, w - sx), 0.0, 1.0)
    cy = torch.clamp(torch.minimum(sy + 1.0, h - sy), 0.0, 1.0)
    # a tensor on the device: a Python scalar divisor (int8's fill over its
    # scale) would become a product with a reciprocal
    fill = torch.as_tensor(fill, dtype=torch.float32, device=sx.device)
    if fill.dim() == 1:
        fill = fill[:, None, None, None]
    cover = torch.where(m == MODE_FILL, 1.0 - cx * cy, torch.zeros_like(cx))
    return torch.stack(idx), torch.stack(valid), hx, hy, cover[:, None], fill


ROWS_EMPTY = (2**31 - 1, -2**31)  # an output row with no tap on the canvas


def tap_row_ranges(inv, modes, work_shape, out_size: int):
    """The plain twin of K2-bf16's row table: per cut and output row, the
    least and the greatest canvas row that a tap on the canvas reads
    (``ROWS_EMPTY`` for a row with none), as (N, S, 2) int32.  The taps are
    the exact warp's (floor of each mode's remapped coordinate, clamped to
    [-2, size + 1]), which K2's rung variants share."""
    h, w, _ = work_shape
    sx, sy = source_coords(inv, out_size)
    m = modes.to(sx.device)[:, None, None]
    tx = torch.where(m == MODE_REFLECT, reflect_coord(sx, w),
                     torch.where(m == MODE_BORDER, sx.clamp(0.0, w - 1.0), sx))
    ty = torch.where(m == MODE_REFLECT, reflect_coord(sy, h),
                     torch.where(m == MODE_BORDER, sy.clamp(0.0, h - 1.0), sy))
    x0 = torch.floor(tx).clamp(-2, w + 1).nan_to_num(-2).long()
    y0 = torch.floor(ty).clamp(-2, h + 1).nan_to_num(-2).long()
    on_x = ((x0 >= 0) & (x0 < w)) | ((x0 + 1 >= 0) & (x0 + 1 < w))
    top = on_x & (y0 >= 0) & (y0 < h)
    bot = on_x & (y0 + 1 >= 0) & (y0 + 1 < h)
    lo_empty, hi_empty = ROWS_EMPTY
    lo = torch.where(top, y0, torch.where(bot, y0 + 1, torch.full_like(y0, lo_empty))).amin(dim=2)
    hi = torch.where(bot, y0 + 1, torch.where(top, y0, torch.full_like(y0, hi_empty))).amax(dim=2)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def warp_modes_rung(work, inv, modes, fill, out_size: int, prec: str):
    """K1's rung variants ("bf16", "high", "int8") as plain ops: (H, W, C)
    float32 canvas → (N, C, S, S) float32, the fill composite included."""
    h, w, c = work.shape
    idx, valid, hx, hy, cover, fill = _rung_taps(work.shape, inv, modes, fill, out_size)
    if prec == "int8":
        src, s_w = quantize_canvas(work)
        scale = _dequant_scale(s_w)
        fill = fill / scale
    else:
        src = work
    flat = src.reshape(h * w, c)

    def tap(k):
        vals = flat.index_select(0, idx[k].reshape(-1)).reshape(*idx[k].shape, c).permute(0, 3, 1, 2)
        return torch.where(valid[k][:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    v00, v01, v10, v11 = (tap(k) for k in range(4))
    hx0, hx1, hy0, hy1 = hx[0][:, None], hx[1][:, None], hy[0][:, None], hy[1][:, None]
    if prec == "int8":
        a0, a1 = torch.round(hy0 * Q127).to(torch.int32), torch.round(hy1 * Q127).to(torch.int32)
        col = lambda top, bot: (a0 * top.to(torch.int32) + a1 * bot.to(torch.int32)).float()
    elif prec == "bf16":
        col = lambda top, bot: _bf(top) * _bf(hy0) + _bf(bot) * _bf(hy1)
    elif prec == "high":
        def col(top, bot):
            d1 = _bf(top) * _bf(hy0) + _bf(bot) * _bf(hy1)
            d2 = _lo(top) * _bf(hy0) + _lo(bot) * _bf(hy1)
            d3 = _bf(top) * _lo(hy0) + _bf(bot) * _lo(hy1)
            return (d1 + d2) + d3
    else:
        raise ValueError(f"warp_modes_rung takes bf16, high or int8; got {prec!r}")
    out = col(v00, v10) * hx0 + col(v01, v11) * hx1 + cover * fill
    return out * scale if prec == "int8" else out


def warp_adjoint_rung(g, inv, modes, work_shape, out_size: int, prec: str):
    """K2's rung variants ("bf16", "high", "int8") of the warp's adjoint as
    plain ops: (N, C, S, S) cotangent → (H, W, C) float32."""
    h, w, c = work_shape
    g = g.float()
    idx, valid, hx, hy, _, _ = _rung_taps(work_shape, inv, modes, 0.0, out_size)
    if prec == "int8":
        s_g = torch.clamp(g.abs().amax(), min=1e-20)
        g = g / s_g
        acc = torch.zeros((h * w * c,), dtype=torch.int64, device=g.device)
    else:
        acc = torch.zeros((h * w * c,), dtype=torch.float32, device=g.device)
    chan = torch.arange(c, device=g.device)[None, :, None, None]
    for k in range(4):
        a, b = hy[k >> 1][:, None], hx[k & 1][:, None]
        if prec == "int8":
            contrib = torch.round((a * g) * Q127).long() * torch.round(b * Q127).long()
        elif prec == "bf16":
            contrib = _bf(a) * _bf(b * g)
        elif prec == "high":
            gb = b * g
            contrib = (_bf(a) * _bf(gb) + _lo(a) * _bf(gb)) + _bf(a) * _lo(gb)
        else:
            raise ValueError(f"warp_adjoint_rung takes bf16, high or int8; got {prec!r}")
        contrib = torch.where(valid[k][:, None], contrib, torch.zeros((), dtype=contrib.dtype, device=g.device))
        acc.index_add_(0, (idx[k][:, None] * c + chan).reshape(-1), contrib.reshape(-1))
    if prec == "int8":
        return (acc.float() * _dequant_scale(s_g)).reshape(h, w, c)
    return acc.reshape(h, w, c)


class _RungWarp(torch.autograd.Function):
    """A rung's forward with a rung's adjoint (both plain)."""

    @staticmethod
    def forward(ctx, work, inv, modes, fill, out_size, prec, bwd):
        ctx.save_for_backward(inv, modes)
        ctx.meta = (tuple(work.shape), out_size, bwd)
        if prec == "highest":
            return warp_modes_plain(work.detach(), inv, modes, fill, out_size)
        return warp_modes_rung(work, inv, modes, fill, out_size, prec)

    @staticmethod
    def backward(ctx, g):
        inv, modes = ctx.saved_tensors
        work_shape, out_size, bwd = ctx.meta
        return warp_adjoint_rung(g, inv, modes, work_shape, out_size, bwd), None, None, None, None, None, None


def warp_modes_prec(work, inv, modes, fill, out_size: int, prec: str = "highest", bwd: str | None = None):
    """:func:`warp_modes_plain` at K1's rung ``prec`` with K2's rung ``bwd``
    for its gradient (None: :func:`norm_prec` of ``prec``); "highest" both
    ways is the exact warp and autograd's adjoint of it."""
    bwd = norm_prec(prec) if bwd is None else bwd
    if prec not in WARP_PRECS or bwd not in WARP_PRECS:
        raise ValueError(f"warp rungs must be among {WARP_PRECS}; got {prec!r}, {bwd!r}")
    if prec == "highest" and bwd == "highest":
        return warp_modes_plain(work, inv, modes, fill, out_size)
    return _RungWarp.apply(work, inv, modes, fill, out_size, prec, bwd)


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
