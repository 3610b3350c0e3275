"""The port's stroke rasterizer on the CPU against the JAX package's fused
Pallas kernels K4s / K5 run in interpret mode (``render_strokes_fused``,
chunk 4), on the scenes and at the tolerances of test_torch_strokes.py.
Tracing the interpreted backward takes ~10-20 s per scene, hence a file
of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops.pallas_strokes import _run_fwd
from pixray_tpu_torch.ops.strokes import composite_premult, premultiply
from test_torch_strokes import SCENES, _assert_grads_close, _jax_result, _port_result


@pytest.mark.parametrize("scene", ["random", "degenerate"])
def test_forward_matches_fused(scene):
    out, _ = _port_result(scene)
    expected, _ = _jax_result(scene, "fused")
    np.testing.assert_allclose(out, expected, atol=1e-4)


@pytest.mark.parametrize("scene", ["random", "degenerate"])
def test_gradients_match_fused(scene):
    _assert_grads_close(_port_result(scene)[1], _jax_result(scene, "fused")[1])


def test_chunk_prefixes_match_fused_store_kernel():
    """The plain version's chunk-entry canvases (what K4s stores) against the
    JAX K4s kernel's, at chunk 4 with a padded last chunk."""
    h, w, basis, (pts, widths, colors, bg) = SCENES["random"]()
    samples = np.einsum("npv,nvd->npd", basis, pts).astype(np.float32)
    bg_p = np.asarray(premultiply(torch.tensor(bg)))
    canvas, ref_prefixes = _run_fwd(jnp.asarray(samples), jnp.asarray(widths), jnp.asarray(colors),
                                    jnp.asarray(bg_p.transpose(2, 0, 1)), True, 4, 32, 128,
                                    store_prefixes=True)
    prefixes = []
    out = composite_premult(torch.tensor(samples), torch.tensor(widths), torch.tensor(colors),
                            torch.tensor(bg_p), chunk=4, prefixes=prefixes)
    assert len(prefixes) == ref_prefixes.shape[0] == 3
    for mine, ref in zip(prefixes, np.asarray(ref_prefixes)):
        np.testing.assert_allclose(mine.numpy().transpose(2, 0, 1), ref, atol=1e-4)
    np.testing.assert_allclose(out.numpy().transpose(2, 0, 1), np.asarray(canvas), atol=1e-4)
