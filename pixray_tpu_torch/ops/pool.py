"""Adaptive average / max pooling of (..., H, W, C) images, torch window semantics.

Port of ``pixray_tpu/ops/pool.py``: windows are
``[floor(i*In/Out), ceil((i+1)*In/Out))``.  Average pooling is two float32
matmuls against fixed row-stochastic matrices; max pooling gathers the padded
windows and reduces with ``amax``, whose gradient splits evenly between tied
maxima exactly as the JAX ``max`` reduction does (flat pixel cells make ties
common, so ``F.adaptive_max_pool2d``'s single-index gradient would differ).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _window_bounds(in_size: int, out_size: int):
    starts = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    ends = np.ceil((np.arange(out_size) + 1) * in_size / out_size).astype(np.int64)
    return starts, ends


@lru_cache(maxsize=32)
def _avg_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    starts, ends = _window_bounds(in_size, out_size)
    cols = np.arange(in_size)
    member = (cols[None, :] >= starts[:, None]) & (cols[None, :] < ends[:, None])
    mat = member.astype(np.float32)
    return mat / mat.sum(axis=1, keepdims=True)


def adaptive_avg_pool(x, out_h: int, out_w: int):
    """x: (..., H, W, C) -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    row = torch.from_numpy(_avg_pool_matrix(h, out_h)).to(x.device)
    col = torch.from_numpy(_avg_pool_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", row, x.float())
    y = torch.einsum("pw,...owc->...opc", col, y)
    return y.to(x.dtype)


@lru_cache(maxsize=32)
def _window_index(in_size: int, out_size: int):
    starts, ends = _window_bounds(in_size, out_size)
    k = int((ends - starts).max())
    idx = starts[:, None] + np.arange(k)[None, :]
    mask = idx < ends[:, None]
    return np.minimum(idx, in_size - 1), mask


def adaptive_max_pool(x, out_h: int, out_w: int):
    """x: (..., H, W, C) -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    rows, rmask = _window_index(h, out_h)
    cols, cmask = _window_index(w, out_w)
    dev = x.device
    rows_t = torch.from_numpy(rows.reshape(-1)).to(dev)
    cols_t = torch.from_numpy(cols.reshape(-1)).to(dev)
    kh, kw = rows.shape[1], cols.shape[1]
    lead = x.shape[:-3]
    wins = x.index_select(-3, rows_t).index_select(-2, cols_t)
    wins = wins.reshape(*lead, out_h, kh, out_w, kw, x.shape[-1])
    mask = torch.from_numpy(rmask[:, :, None, None] & cmask[None, None, :, :]).to(dev)[..., None]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
    return torch.amax(torch.where(mask, wins, neg), dim=(-4, -2))
