"""Blocked runs against single-step runs in the port, on the CPU.

A pixel and a clipdraw run (TinyTest, an LR drop and checkins inside the
run; pixel also with two batches over a transparent canvas; the fft drawer
with two batches, the wallpaper and tiler filters and three custom losses)
with ``steps_per_call`` 8 and 1 from one seed: per-step losses, the final
latent, the optimizer state and the checkin images bitwise equal (on the
CPU a block is its steps in a loop, from inputs staged as the card's graph
reads them, so nothing may differ).  The scheduling tests, the draw order
and the image run with an overlay are in ``test_torch_blocks.py``; the
runs live in a file of their own so that the two files run on two workers.
"""

import pytest
import torch

from pixray_tpu_torch.engine.latent import leaves
from pixray_tpu_torch.engine.optimizers import state_tensors
from test_torch_blocks import _run
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")


@pytest.mark.parametrize("drawer", [
    dict(drawer="pixel"), dict(drawer="clipdraw", strokes=12),
    # two batches, and the transparency composite over each batch's fill
    dict(drawer="pixel", batches=2, transparent=True, transparent_weight=0.5),
    # filter shifts and the iteration in the staged int32 tail, and custom losses
    dict(drawer="fft", fft_use="dwt", batches=2, filters="wallpaper,tiler", wallpaper_type="shift",
         custom_loss="smoothness:0.5,saturation,symmetry"),
], ids=["pixel", "clipdraw", "pixel-batches2-transparent", "fft-filters-losses"])
def test_blocked_run_equals_single_steps(tmp_path, drawer):
    blocked, b_losses, b_images, b_blocks = _run(tmp_path, "blocked", 8, **drawer)
    single, s_losses, s_images, s_blocks = _run(tmp_path, "single", 1, **drawer)
    # checkins at 0, 10, 20 and 24, the LR drop at 11: blocks 1-8 and 12-19
    assert blocked.args.learning_rate_drops == [11]
    assert b_blocks == [(1, 8), (12, 8)] and s_blocks == []
    assert blocked.tracker.num_loss_drop == single.tracker.num_loss_drop == 1
    assert len(b_losses) == len(s_losses) == 24
    for it, (a, b) in enumerate(zip(b_losses, s_losses)):
        assert torch.equal(a, b), it
    for a, b in zip(leaves(blocked.z), leaves(single.z)):
        assert torch.equal(a, b)
    for a, b in zip(state_tensors(blocked.opt_state), state_tensors(single.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(blocked.lr_scale, single.lr_scale)
    assert sorted(b_images) == sorted(s_images) == [
        "frame_0000.png", "frame_0010.png", "frame_0020.png", "frame_0024.png", "output.png"]
    assert b_images == s_images
