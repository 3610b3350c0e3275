"""Static-geometry cell renderer for the pixel drawer (port of ``pixray_tpu/ops/cellrender.py``).

The polygon grid never changes, so its 2x2-supersampled painter-order
coverage map is built once on the host (numpy; the same algorithm as the
JAX package's numpy path and its optional C++ rasterizer), and the render
is a function of the per-cell RGBA fills only.  For the plain rectangle grid
the map factorizes and the whole render is two small float32 matmuls
(``composite_cells_separable``).  The other geometries (shifted rows,
overlapping cells, uncovered subsamples) take ``composite_cells``: a
gather of the cells' colours at each subsample's painter stack, the "over"
composite from the deepest slot up and the SS box filter.  Its colour
gradient is a gather too, of the cotangent at each cell's slots in the
static inverse map (``build_inverse_map``), summed in slot order: no
scatter and no float atomics.
"""

from __future__ import annotations

import numpy as np
import torch

DEPTH = 4  # max overlapping cells per subsample
SS = 2  # supersampling factor


def _points_in_polygon(pts, poly):
    """Even-odd rule point-in-polygon test. pts (M, 2), poly (V, 2) → (M,) bool."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), dtype=bool)
    v = np.asarray(poly)
    n = len(v)
    j = n - 1
    for i in range(n):
        xi, yi = v[i]
        xj, yj = v[j]
        crosses = ((yi > y) != (yj > y)) & (x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi)
        inside ^= crosses
        j = i
    return inside


def _trim_depth(indices, valid):
    """Drop depth slots no subsample uses."""
    used = valid.reshape(-1, valid.shape[-1]).any(axis=0)
    eff = max(int(used.sum()), 1)
    return indices[..., :eff], valid[..., :eff]


def build_coverage_map(polygons, canvas_width: int, canvas_height: int):
    """Supersampled painter-order coverage map.

    polygons: list of (V, 2) arrays in canvas pixel coordinates, draw order.
    Returns (indices, valid), both (H*SS, W*SS, depth_eff) int32/bool, with
    indices[..., 0] the TOPMOST covering cell."""
    hs, ws = canvas_height * SS, canvas_width * SS
    offs = (np.arange(SS) + 0.5) / SS
    ys = (np.arange(canvas_height)[:, None] + offs[None, :]).reshape(-1)
    xs = (np.arange(canvas_width)[:, None] + offs[None, :]).reshape(-1)

    indices = np.full((hs, ws, DEPTH), 0, dtype=np.int32)
    counts = np.zeros((hs, ws), dtype=np.int32)

    for cell_idx, poly in enumerate(polygons):
        poly = np.asarray(poly, dtype=np.float64)
        x0 = max(int(np.floor(poly[:, 0].min() * SS)), 0)
        x1 = min(int(np.ceil(poly[:, 0].max() * SS)) + 1, ws)
        y0 = max(int(np.floor(poly[:, 1].min() * SS)), 0)
        y1 = min(int(np.ceil(poly[:, 1].max() * SS)) + 1, hs)
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.meshgrid(xs[x0:x1], ys[y0:y1])
        pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
        inside = _points_in_polygon(pts, poly).reshape(y1 - y0, x1 - x0)

        sub_idx = indices[y0:y1, x0:x1]
        # push-front: the newest (topmost) shape goes to slot 0
        for d in range(DEPTH - 1, 0, -1):
            sub_idx[..., d] = np.where(inside, sub_idx[..., d - 1], sub_idx[..., d])
        sub_idx[..., 0] = np.where(inside, cell_idx, sub_idx[..., 0])
        counts[y0:y1, x0:x1] += inside

    valid_depth = np.arange(DEPTH)[None, None, :] < np.minimum(counts, DEPTH)[..., None]
    return _trim_depth(indices, valid_depth)


def try_separable_operators(indices, valid, num_rows: int, num_cols: int):
    """Factorize a depth-1, fully covered map into (R (H, rows), C (cols, W))
    float32 operators with the 1/SS box weights folded in, or None."""
    indices = np.asarray(indices)
    valid = np.asarray(valid)
    if indices.shape[-1] != 1 or not bool(valid.all()):
        return None
    idx = indices[..., 0]
    row_id = idx[:, 0] // num_cols
    col_id = idx[0, :] % num_cols
    if not np.array_equal(row_id[:, None] * num_cols + col_id[None, :], idx):
        return None
    hs, ws = idx.shape
    height, width = hs // SS, ws // SS
    r_op = np.zeros((height, num_rows), np.float32)
    np.add.at(r_op, (np.repeat(np.arange(height), SS), row_id), 1.0 / SS)
    c_op = np.zeros((num_cols, width), np.float32)
    np.add.at(c_op, (col_id, np.repeat(np.arange(width), SS)), 1.0 / SS)
    return r_op, c_op


def composite_cells_separable(colors, r_op, c_op, num_rows: int, num_cols: int):
    """(cells, 4) RGBA → (H, W, 4): premultiplied over transparent black,
    box-filtered, as two float32 matmuls."""
    a = colors[:, 3:4]
    prem = torch.cat([colors[:, :3] * a, a], dim=1)
    p = prem.reshape(num_rows, num_cols * 4)
    t = torch.matmul(r_op, p).reshape(-1, num_cols, 4)
    return torch.einsum("hck,cw->hwk", t, c_op)


def build_inverse_map(indices, valid, num_cells: int):
    """Static inverse of the coverage map for a scatter-free backward pass.

    Returns (cell_slots (cells, max_occ) int32, cell_slot_valid (cells,
    max_occ) bool): for each cell, the flat indices of the (subsample,
    depth) slots it occupies in ascending order, padded to the largest
    occupancy."""
    flat_idx = np.asarray(indices).reshape(-1)
    flat_valid = np.asarray(valid).reshape(-1)
    slot_ids = np.arange(flat_idx.size, dtype=np.int64)

    # slots sorted by cell id (invalid slots go to a sentinel bucket)
    keyed = np.where(flat_valid, flat_idx, num_cells)
    order = np.argsort(keyed, kind="stable")
    sorted_cells = keyed[order]
    sorted_slots = slot_ids[order]

    counts = np.bincount(sorted_cells, minlength=num_cells + 1)[:num_cells]
    max_occ = int(counts.max()) if counts.size else 1
    starts = np.zeros(num_cells, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])

    cell_slots = np.zeros((num_cells, max_occ), dtype=np.int32)
    cell_valid = np.arange(max_occ)[None, :] < counts[:, None]
    for_cell = np.repeat(np.arange(num_cells), counts)
    pos_in_cell = np.arange(for_cell.size) - np.repeat(starts, counts)
    cell_slots[for_cell, pos_in_cell] = sorted_slots[: for_cell.size]
    return cell_slots, cell_valid


class _TakeCells(torch.autograd.Function):
    """``colors[indices]`` whose adjoint is a gather of the cotangent at the
    precomputed ``cell_slots``, masked and summed over the slots (the JAX
    package's ``_take_cells`` custom VJP), where the default adjoint of an
    index would scatter with ``index_add_``."""

    @staticmethod
    def forward(ctx, colors, indices, cell_slots, cell_valid):
        ctx.save_for_backward(cell_slots, cell_valid)
        flat = colors.index_select(0, indices.reshape(-1).long())
        return flat.view(*indices.shape, colors.shape[-1])

    @staticmethod
    def backward(ctx, g):
        cell_slots, cell_valid = ctx.saved_tensors
        c = g.shape[-1]
        flat_g = g.reshape(-1, c)  # one row per (subsample, depth) slot
        per_cell = flat_g.index_select(0, cell_slots.reshape(-1).long()).view(*cell_slots.shape, c)
        per_cell = torch.where(cell_valid[..., None], per_cell, per_cell.new_zeros(()))
        return per_cell.sum(dim=1), None, None, None


def composite_cells(colors, indices, valid, canvas_height: int, canvas_width: int, inverse_map):
    """Per-cell RGBA (cells, 4) → (H, W, 4) canvas: back-to-front "over"
    per subsample over the trimmed painter stack (slot 0 is the topmost),
    then the SS box filter.  ``inverse_map``: (cell_slots, cell_slot_valid)
    of :func:`build_inverse_map`, on the colours' device."""
    cell_slots, cell_valid = inverse_map
    gathered = _TakeCells.apply(colors, indices, cell_slots, cell_valid)  # (hs, ws, depth, 4)
    valid = valid[..., None]
    hs, ws = gathered.shape[0], gathered.shape[1]
    rgb = colors.new_zeros((hs, ws, 3))
    alpha = colors.new_zeros((hs, ws, 1))
    for d in range(gathered.shape[2] - 1, -1, -1):
        layer = gathered[:, :, d, :]
        a = torch.where(valid[:, :, d, :], layer[..., 3:4], layer.new_zeros(()))
        rgb = a * layer[..., :3] + (1.0 - a) * rgb
        alpha = a + (1.0 - a) * alpha
    out = torch.cat([rgb, alpha], dim=-1)
    return out.reshape(canvas_height, SS, canvas_width, SS, 4).mean(dim=(1, 3))
