"""Adaptive average / max pooling and resampling of (..., H, W, C) images.

Port of ``pixray_tpu/ops/pool.py``: windows are
``[floor(i*In/Out), ceil((i+1)*In/Out))``.  Average pooling is two float32
matmuls against fixed row-stochastic matrices; max pooling gathers the padded
windows and reduces with ``amax``, whose gradient splits evenly between tied
maxima exactly as the JAX ``max`` reduction does (flat pixel cells make ties
common, so ``F.adaptive_max_pool2d``'s single-index gradient would differ).
Nearest resizing (``nearest_resize``, the fast_pixel drawer's render) is
two 0/1 matmuls, as in the JAX package.  The matrices and indices are made
on the device once per shape: a pooling or resizing call copies nothing
from the host, so a CUDA graph can capture it.  ``linear_resize`` is
``jax.image.resize``'s antialiased bilinear resize, used once on the host
(fast_pixel's ``params_from_image``).
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


def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) 0/1 matrix of nearest-neighbour resampling, ``jax.image``'s
    convention: src = floor((i + 0.5) * in / out)."""
    src = np.floor((np.arange(out_size) + 0.5) * in_size / out_size).astype(np.int64)
    src = np.clip(src, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[np.arange(out_size), src] = 1.0
    return mat


@lru_cache(maxsize=64)
def _nearest_operator(in_size: int, out_size: int, device: torch.device):
    return torch.from_numpy(_nearest_matrix(in_size, out_size)).to(device)


def nearest_resize(x, out_h: int, out_w: int):
    """Nearest-neighbour resize of (..., H, W, C) as two 0/1 matmuls (the
    JAX package's form: exact forward, a deterministic gradient)."""
    h, w = x.shape[-3], x.shape[-2]
    row = _nearest_operator(h, out_h, x.device)
    col = _nearest_operator(w, out_w, x.device)
    y = torch.einsum("oh,...hwc->...owc", row, x.float())
    y = torch.einsum("pw,...owc->...opc", col, y)
    return y.to(x.dtype)


def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize(method="bilinear")`` along one
    axis (``compute_weight_mat`` with the triangle kernel and antialiasing:
    when downsampling the kernel widens by in / out), in its float32 order."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32).T


def linear_resize(x, out_h: int, out_w: int):
    """Bilinear resize of an (H, W, C) image with ``jax.image.resize``'s
    antialiasing (a triangle kernel widened when downsampling), as one
    float32 matmul per axis whose size changes."""
    h, w = x.shape[-3], x.shape[-2]
    y = x.float()
    if h != out_h:
        y = torch.einsum("oh,hwc->owc", torch.from_numpy(_linear_matrix(h, out_h)).to(y.device), y)
    if w != out_w:
        y = torch.einsum("pw,owc->opc", torch.from_numpy(_linear_matrix(w, out_w)).to(y.device), y)
    return y
