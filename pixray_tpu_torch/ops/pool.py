"""Adaptive average / max pooling of (..., H, W, C) images, torch window semantics.

Port of ``pixray_tpu/ops/pool.py``: windows are
``[floor(i*In/Out), ceil((i+1)*In/Out))``.  Average pooling is two float32
matmuls against fixed row-stochastic matrices; max pooling gathers the padded
windows and reduces with ``amax``, whose gradient splits evenly between tied
maxima exactly as the JAX ``max`` reduction does (flat pixel cells make ties
common, so ``F.adaptive_max_pool2d``'s single-index gradient would differ).
The matrices and indices are made on the device once per shape: a pooling
call copies nothing from the host, so a CUDA graph can capture it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _window_bounds(in_size: int, out_size: int):
    starts = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    ends = np.ceil((np.arange(out_size) + 1) * in_size / out_size).astype(np.int64)
    return starts, ends


def _avg_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    starts, ends = _window_bounds(in_size, out_size)
    cols = np.arange(in_size)
    member = (cols[None, :] >= starts[:, None]) & (cols[None, :] < ends[:, None])
    mat = member.astype(np.float32)
    return mat / mat.sum(axis=1, keepdims=True)


@lru_cache(maxsize=64)
def _avg_pool_operator(in_size: int, out_size: int, device: torch.device):
    return torch.from_numpy(_avg_pool_matrix(in_size, out_size)).to(device)


@lru_cache(maxsize=64)
def _window_operators(in_size: int, out_size: int, device: torch.device):
    """(flat window indices, window mask) of one axis on ``device``."""
    idx, mask = _window_index(in_size, out_size)
    return torch.from_numpy(idx.reshape(-1)).to(device), torch.from_numpy(mask).to(device)


def adaptive_avg_pool(x, out_h: int, out_w: int):
    """x: (..., H, W, C) -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    row = _avg_pool_operator(h, out_h, x.device)
    col = _avg_pool_operator(w, out_w, x.device)
    y = torch.einsum("oh,...hwc->...owc", row, x.float())
    y = torch.einsum("pw,...owc->...opc", col, y)
    return y.to(x.dtype)


def _window_index(in_size: int, out_size: int):
    starts, ends = _window_bounds(in_size, out_size)
    k = int((ends - starts).max())
    idx = starts[:, None] + np.arange(k)[None, :]
    mask = idx < ends[:, None]
    return np.minimum(idx, in_size - 1), mask


def adaptive_max_pool(x, out_h: int, out_w: int):
    """x: (..., H, W, C) -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    rows_t, rmask = _window_operators(h, out_h, x.device)
    cols_t, cmask = _window_operators(w, out_w, x.device)
    kh, kw = rmask.shape[1], cmask.shape[1]
    lead = x.shape[:-3]
    wins = x.index_select(-3, rows_t).index_select(-2, cols_t)
    wins = wins.reshape(*lead, out_h, kh, out_w, kw, x.shape[-1])
    mask = (rmask[:, :, None, None] & cmask[None, None, :, :])[..., None]
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    return torch.amax(torch.where(mask, wins, neg), dim=(-4, -2))
