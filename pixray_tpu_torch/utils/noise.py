"""Fractal-noise init image (the ``--init_noise pixels`` default), numpy only.

Same draws and math as ``pixray_tpu.utils.noise.random_noise_image``, which
then wraps the array in a PIL image; here the uint8 array is returned as is.
"""

from __future__ import annotations

import numpy as np


def _perlin_2d(shape, res, rng: np.random.Generator):
    """Single-octave 2D Perlin noise on a ``shape`` grid with ``res`` cells."""
    d0, d1 = shape[0] // res[0], shape[1] // res[1]
    angles = 2 * np.pi * rng.random((res[0] + 1, res[1] + 1))
    gradients = np.stack([np.cos(angles), np.sin(angles)], axis=-1)

    gy, gx = np.meshgrid(
        np.arange(shape[0]) / d0 % 1, np.arange(shape[1]) / d1 % 1, indexing="ij"
    )
    cy = (np.arange(shape[0]) // d0).astype(int)
    cx = (np.arange(shape[1]) // d1).astype(int)

    def dot_corner(oy, ox):
        g = gradients[cy[:, None] + oy, cx[None, :] + ox]  # (H, W, 2)
        return (gy - oy) * g[..., 0] + (gx - ox) * g[..., 1]

    def fade(t):
        return 6 * t**5 - 15 * t**4 + 10 * t**3

    u, v = fade(gy), fade(gx)
    n00, n01 = dot_corner(0, 0), dot_corner(0, 1)
    n10, n11 = dot_corner(1, 0), dot_corner(1, 1)
    top = n00 * (1 - v) + n01 * v
    bot = n10 * (1 - v) + n11 * v
    return np.sqrt(2) * (top * (1 - u) + bot * u)


def fractal_noise_2d(shape, res, octaves: int, rng: np.random.Generator, persistence=0.5):
    noise = np.zeros(shape)
    frequency, amplitude = 1, 1.0
    for _ in range(octaves):
        noise += amplitude * _perlin_2d(shape, (frequency * res[0], frequency * res[1]), rng)
        frequency *= 2
        amplitude *= persistence
    return noise


def _normalize(data):
    lo, hi = np.min(data), np.max(data)
    return (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)


def contrast_noise(n):
    n = 0.9998 * n + 0.0001
    return 1 / (1 + np.power(n / (1 - n), -2))


def random_noise_array(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    """(h, w, 3) uint8 fractal-noise image."""
    if w > 1024 or h > 1024:
        side, octp = 2048, 6
    elif w > 512 or h > 512:
        side, octp = 1024, 5
    elif w > 256 or h > 256:
        side, octp = 512, 4
    else:
        side, octp = 256, 3

    channels = [
        contrast_noise(_normalize(fractal_noise_2d((side, side), (32, 32), octp, rng)))
        for _ in range(3)
    ]
    stack = np.dstack(channels)[:h, :w, :]
    return (255.999 * stack).astype("uint8")
