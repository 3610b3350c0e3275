"""The filters of the port (tiler, wallpaper, lookup) against the JAX
package's on the CPU, fed the JAX filters' own draws.

- The draws: a JAX filter draws ``randint(kh, (), 0, h)`` and
  ``randint(kw, (), 0, w)`` from its key over its INPUT's shape; the port
  filter gets those two numbers as a (2,) int32 tensor.  ``out_shape``
  must give the shape the filter leaves.
- tiler, and wallpaper in every mode (default, ``shift``, ``horizontal``,
  ``vertical``), each without and with edge matching (4 and an odd 5):
  image bitwise (a roll is a gather), loss within 1e-7, and the gradient
  of a weighted sum of image and loss w.r.t. the input within 1e-6.
- lookup: the snapped image bitwise, the commitment loss within 1e-6, the
  straight-through gradient (the identity for the image, the commitment
  term's for the loss) within 1e-6, the alpha channel passed through, on
  pixels placed near midpoints between palette colours (the nearest colour
  by the expanded form, first index on ties); the built-in table when
  there is no palette.
- The roll by a device shift follows ``jnp.roll`` for shifts past the size
  and for negative ones.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.filters.lookup import ColorLookup as JLookup
from pixray_tpu.filters.tiler import TilerFilter as JTiler
from pixray_tpu.filters.wallpaper import WallpaperFilter as JWallpaper
from pixray_tpu_torch.filters import filter_class
from pixray_tpu_torch.filters.base import roll
from pixray_tpu_torch.filters.lookup import ColorLookup
from pixray_tpu_torch.filters.tiler import TilerFilter
from pixray_tpu_torch.filters.wallpaper import WallpaperFilter


def jax_filter_draws(key, h, w):
    """The (rand_h, rand_w) a JAX filter draws from ``key`` for an (h, w) input."""
    kh, kw = jax.random.split(key)
    return int(jax.random.randint(kh, (), 0, h)), int(jax.random.randint(kw, (), 0, w))


def _compare(ref, port, img, key):
    h, w = img.shape[:2]
    draws = jax_filter_draws(key, h, w)
    want_img, want_loss = ref(jnp.asarray(img), key)
    x = torch.tensor(img, requires_grad=True)
    got_img, got_loss = port(x, torch.tensor(draws, dtype=torch.int32))
    assert tuple(got_img.shape) == want_img.shape == port.out_shape(h, w) + (img.shape[2],)
    np.testing.assert_array_equal(got_img.detach().numpy(), np.asarray(want_img))
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), atol=1e-7)
    g = np.random.default_rng(1).standard_normal(want_img.shape).astype(np.float32)
    want_grad = jax.grad(lambda a: jnp.sum(ref(a, key)[0] * g) + 3.0 * ref(a, key)[1])(jnp.asarray(img))
    ((got_img * torch.tensor(g)).sum() + 3.0 * got_loss).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-6)


@pytest.mark.parametrize("shape", [(12, 20, 3), (9, 14, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiler_matches_jax(shape, seed):
    img = np.random.default_rng(seed).random(shape).astype(np.float32)
    _compare(JTiler(None), TilerFilter(None), img, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("wallpaper_type", [None, "shift", "horizontal", "vertical"])
@pytest.mark.parametrize("edge_match", [0, 4, 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_wallpaper_matches_jax(wallpaper_type, edge_match, seed):
    s = SimpleNamespace(wallpaper_type=wallpaper_type, wallpaper_edge_match=edge_match)
    img = np.random.default_rng(seed).random((12, 18, 3)).astype(np.float32)
    _compare(JWallpaper(s), WallpaperFilter(s), img, jax.random.fold_in(jax.random.PRNGKey(seed), 3))


def test_roll_follows_jnp_roll():
    x = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    for shift in (0, 3, 7, 9, 13, -2):
        for dim in (0, 1):
            want = np.asarray(jnp.roll(jnp.asarray(x.numpy()), shift, axis=dim))
            np.testing.assert_array_equal(roll(x, torch.tensor(shift, dtype=torch.int32), dim).numpy(), want)


def _lookup_image(table, shape, seed):
    """Pixels near the midpoints of palette pairs (ties within rounding),
    plus random ones, in [0, 1]."""
    rng = np.random.default_rng(seed)
    n = shape[0] * shape[1]
    a, b = rng.integers(0, len(table), n), rng.integers(0, len(table), n)
    mid = 0.5 * (table[a] + table[b]) + rng.normal(0, 1e-4, (n, 3))
    rand = rng.random((n, 3))
    pix = np.where(rng.random((n, 1)) < 0.5, mid, rand).clip(0, 1).astype(np.float32)
    img = pix.reshape(shape[0], shape[1], 3)
    if shape[2] == 4:
        img = np.concatenate([img, rng.random(shape[:2] + (1,)).astype(np.float32)], axis=-1)
    return img


@pytest.mark.parametrize("palette", [None, [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.9, 0.1, 0.1], [0.2, 0.4, 0.8]]])
@pytest.mark.parametrize("channels", [3, 4])
def test_lookup_matches_jax(palette, channels):
    s = SimpleNamespace(lookup_beta=10.0, palette=palette)
    ref, port = JLookup(s), ColorLookup(s)
    table = np.asarray(ref.color_table)
    np.testing.assert_array_equal(port.color_table.numpy(), table)
    img = _lookup_image(table, (10, 14, channels), seed=channels)
    key = jax.random.PRNGKey(0)
    want_img, want_loss = ref(jnp.asarray(img), key)
    x = torch.tensor(img, requires_grad=True)
    got_img, got_loss = port(x, torch.zeros(2, dtype=torch.int32))
    np.testing.assert_array_equal(got_img.detach().numpy(), np.asarray(want_img))
    if channels == 4:
        np.testing.assert_array_equal(got_img.detach().numpy()[..., 3], img[..., 3])
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-6)
    g = np.random.default_rng(2).standard_normal(want_img.shape).astype(np.float32)
    want_grad = jax.grad(lambda a: jnp.sum(ref(a, key)[0] * g) + 2.0 * ref(a, key)[1])(jnp.asarray(img))
    ((got_img * torch.tensor(g)).sum() + 2.0 * got_loss).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-6)


def test_filter_registry():
    assert filter_class("tiler") is TilerFilter
    assert filter_class("wallpaper") is WallpaperFilter
    assert filter_class("lookup") is ColorLookup
    with pytest.raises(KeyError):
        filter_class("blur")
