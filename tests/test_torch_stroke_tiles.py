"""The plain twins of the state K4s saves for K5 (``ops/strokes.py``):
``tile_stroke_lists``, each tile's ascending list of the strokes whose
margined bbox meets it, and ``tile_chunk_canvases``, the tile-local canvas
at the entry of each chunk of that list.  ``chip_smoke.py`` holds the CUDA
kernels' lists to these exactly and their canvases within 1e-4.

Held here against a brute-force bbox test, against the plain renderer run
one stroke at a time (``composite_premult(chunk=1)``, whose canvas before
every stroke is there to gather; within 1e-6: the same f32 ops on the same
values) and against the JAX K4s kernel at chunk 1 in interpret mode (atol
1e-4, the fused-vs-XLA forward tolerance of tests/test_pallas_strokes.py).
Scenes: those of test_torch_strokes.py (40x140 and 24x40: ragged last tile
row and column; alpha 0, off-canvas and zero-length strokes) and a crowded
one (``crowded_scene``: 300 short strokes in a 32x32 region of a 64x96
canvas, lists with entries from all three of a kernel's 128-stroke build
rounds, in up to 11 chunks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops.pallas_strokes import _run_fwd
from pixray_tpu_torch.ops.strokes import (composite_premult, crowded_scene, pack_meta, premultiply,
                                          tile_chunk_canvases, tile_stroke_lists)
from test_torch_strokes import SCENES

TILES = [(16, 16), (8, 16), (4, 16)]


def _scene(name):
    """(h, w, samples, widths, colors, premultiplied (H, W, 4) background) as torch f32."""
    if name == "crowded":
        h, w, samples, widths, colors, bg = crowded_scene()
    else:
        h, w, basis, (pts, widths, colors, bg) = SCENES[name]()
        samples = np.einsum("npv,nvd->npd", basis, pts)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return h, w, f32(samples), f32(widths), f32(colors), premultiply(f32(bg))


def _brute_force_lists(meta, h, w, tile):
    th, tw = tile
    m = meta.numpy()
    lists = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            lists.append([s for s in range(m.shape[0])
                          if m[s, 5] <= np.float32(x0 + tw) and m[s, 7] >= np.float32(x0)
                          and m[s, 6] <= np.float32(y0 + th) and m[s, 8] >= np.float32(y0)])
    return lists


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("scene", ["random", "degenerate", "ties", "zero_alpha", "crowded"])
def test_tile_stroke_lists_match_brute_force(scene, tile):
    h, w, samples, widths, colors, _ = _scene(scene)
    meta = pack_meta(samples, widths, colors)
    lists = tile_stroke_lists(meta, h, w, tile)
    expected = _brute_force_lists(meta, h, w, tile)
    assert len(lists) == -(-h // tile[0]) * -(-w // tile[1])
    assert [l.tolist() for l in lists] == expected
    for l in lists:
        assert torch.all(l[1:] > l[:-1])
    listed = set(sum(expected, []))
    zero_alpha = [s for s in range(len(colors)) if colors[s, 3] == 0]
    if scene in ("zero_alpha", "crowded"):
        assert zero_alpha and set(zero_alpha) <= listed  # alpha-0 strokes stay on the lists
    if scene == "degenerate":
        assert 0 not in listed  # the off-canvas stroke is on no list
    if scene == "crowded":
        # a list that crosses both of a kernel's 128-stroke build rounds, in many chunks
        assert any(len(l) > 4 * 16 and l[0] < 128 and l[-1] >= 256 for l in expected)
        assert min(len(l) for l in lists) == 0  # and tiles with no strokes sit beside it


def test_tile_stroke_lists_no_strokes():
    lists = tile_stroke_lists(torch.zeros((0, 9)), 40, 140, (16, 16))
    assert len(lists) == 3 * 9 and all(l.numel() == 0 for l in lists)
    out = tile_chunk_canvases(torch.zeros((0, 5, 2)), torch.zeros(0), torch.zeros((0, 4)),
                              torch.rand((40, 140, 4)), lists, tile=(16, 16))
    assert out.shape == (27, 0, 4, 16, 16)


def _gather(prefixes, lists, h, w, chunk, tile):
    """Full-canvas (H, W, 4) prefixes, one per stroke → (T, S, 4, th, tw) at
    each list chunk's entry, zero past the canvas and in absent chunks."""
    th, tw = tile
    ty, tx = -(-h // th), -(-w // tw)
    slots = max(-(-len(l) // chunk) for l in lists)
    out = torch.zeros((len(lists), slots, 4, th, tw))
    for t, l in enumerate(lists):
        y0, x0 = (t // tx) * th, (t % tx) * tw
        for j in range(-(-len(l) // chunk)):
            crop = prefixes[int(l[j * chunk])][y0:y0 + th, x0:x0 + tw].permute(2, 0, 1)
            out[t, j, :, :crop.shape[1], :crop.shape[2]] = crop
    assert ty * tx == len(lists)
    return out


@pytest.mark.parametrize("scene,chunk,tile", [("random", 2, (16, 16)), ("random", 3, (8, 16)),
                                              ("ties", 1, (16, 16)), ("zero_alpha", 2, (16, 16)),
                                              ("crowded", 16, (16, 16)), ("crowded", 16, (8, 16))])
def test_tile_chunk_canvases_match_sequential_prefixes(scene, chunk, tile):
    h, w, samples, widths, colors, bg = _scene(scene)
    lists = tile_stroke_lists(pack_meta(samples, widths, colors), h, w, tile)
    prefixes = []
    with torch.no_grad():
        composite_premult(samples, widths, colors, bg, chunk=1, prefixes=prefixes)
    got = tile_chunk_canvases(samples, widths, colors, bg, lists, chunk=chunk, tile=tile)
    expected = _gather(prefixes, lists, h, w, chunk, tile)
    assert got.shape == expected.shape and got.shape[1] > 1
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=0, atol=1e-6)


def test_tile_chunk_canvases_match_jax_store_kernel():
    """Against the JAX K4s kernel at chunk 1 (interpret mode): its canvas at
    every stroke's entry, gathered at the list chunks' entries."""
    h, w, samples, widths, colors, bg = _scene("random")
    chunk, tile = 2, (16, 16)
    canvas, ref = _run_fwd(jnp.asarray(samples.numpy()), jnp.asarray(widths.numpy()), jnp.asarray(colors.numpy()),
                           jnp.asarray(bg.numpy().transpose(2, 0, 1)), True, 1, 32, 128, store_prefixes=True)
    ref = torch.tensor(np.asarray(ref)).permute(0, 2, 3, 1)  # (N, H, W, 4)
    lists = tile_stroke_lists(pack_meta(samples, widths, colors), h, w, tile)
    got = tile_chunk_canvases(samples, widths, colors, bg, lists, chunk=chunk, tile=tile)
    expected = _gather(ref, lists, h, w, chunk, tile)
    assert got.shape == expected.shape and got.shape[1] > 1
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=0, atol=1e-4)
