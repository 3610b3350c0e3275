"""The plug-in slice end to end against the JAX engine on the CPU: filters
and custom losses inside the step, with the JAX engine's own draws (the
cuts, and each filter's shifts) replayed in the port.

- ``fft --fft_use dwt`` with ``wallpaper --wallpaper_type shift``,
  ``smoothness:0.5`` and ``saturation``, 48x32, 8 cuts, 3 steps, on one
  TinyTest tower and on two towers of one cut size (TinyTest and
  TinyTestDim48, both 32 px): the JAX step keys ``cur_cutouts`` by cut
  size, so the second tower's bank replaces the first's and the losses see
  only the last tower's cutouts; the port must do the same.
- The pixel drawer (transparent) with ``lookup,tiler`` and ``symmetry``,
  ``palette``, ``gaussian``, ``edge`` and ``aesthetic`` under a palette
  string.  Its colours lie inside (0, 1) and have three distinct channels:
  the jitter's HSV round trip splits the gradient where a pixel sits on
  the clip bound 0 or 1 or where two channels tie (the max and min
  channel), and the warped values of a snapped region move by ~1e-6
  between the packages (the JAX package's separable matmuls for the
  axis-aligned cuts, the port's one warp), so a region on such a tie takes
  another gradient in each package (up to 100% of it; in either package
  alone too, across devices).
- Per-step loss within 1e-4 and the latent within 1e-3, as
  tests/test_torch_engine.py holds the pixel slice; the term names equal.
- A recording loss sees one cut size, holding the last bank.
- The four ``cogs/tiler_*.yaml`` recipes resolve to the JAX package's
  settings through the two-pass parse (filters and losses inject their
  flags).
"""

import os

import jax
import numpy as np
import pytest
import torch

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.losses import add_custom_loss
from pixray_tpu_torch.losses.base import LossInterface
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.ops import cuda_warp
from test_torch_engine import _jax_perceptor_draws
from test_torch_filters import jax_filter_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(
    prompts="sunrise", size=[48, 32], num_cuts=8, batches=1, iterations=3, save_every=100000,
    display_every=100000, init_noise=None, vector_prompts="none", seed=1, save_intermediates=False,
    learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
)
SLICES = {
    "dwt_wallpaper": dict(drawer="fft", fft_use="dwt", clip_models="TinyTest", filters="wallpaper",
                          wallpaper_type="shift", custom_loss="smoothness:0.5,saturation"),
    "dwt_two_towers_one_size": dict(drawer="fft", fft_use="dwt", clip_models="TinyTest,TinyTestDim48",
                                    filters="wallpaper", wallpaper_type="shift",
                                    custom_loss="smoothness:0.5,saturation"),
    "pixel_plugins": dict(drawer="pixel", clip_models="TinyTest", transparent=True, filters="lookup,tiler:0.5",
                          custom_loss="symmetry,palette:2,gaussian,edge,aesthetic",
                          palette="(200,40,70)->(40,90,200)\\4;[(230+200+60), (90+160+120)]", pixel_size=[12, 8], edge_thickness=10),
}
NAMES = {
    "dwt_wallpaper": ["filter:WallpaperFilter", "TinyTest:prompt0", "loss:SmoothnessLoss:0",
                      "loss:SaturationLoss:0"],
    "dwt_two_towers_one_size": ["filter:WallpaperFilter", "TinyTest:prompt0", "TinyTestDim48:prompt0",
                                "loss:SmoothnessLoss:0", "loss:SaturationLoss:0"],
    "pixel_plugins": ["filter:ColorLookup", "filter:TilerFilter", "TinyTest:prompt0", "loss:SymmetryLoss",
                      "loss:PaletteLoss:0", "loss:GaussianLoss", "loss:EdgeLoss", "loss:AestheticLoss"],
}


def jax_step_draws(k_step, cut_sizes, num_cuts, aspect, batches, filters, canvas_hw):
    """One JAX step's draws: the cuts as ``test_torch_engine`` splits them,
    and filter i's shifts from ``fold_in(k_loss, i)`` over the shape the
    filters before it leave."""
    out = []
    for key in jax.random.split(k_step, batches):
        _k_synth, k_fill, k_loss, *pks = jax.random.split(key, 3 + len(cut_sizes))
        shifts, (h, w) = [], canvas_hw
        for i, filt in enumerate(filters):
            shifts.append(jax_filter_draws(jax.random.fold_in(k_loss, i), h, w))
            h, w = filt.out_shape(h, w)
        out.append({
            "fill": float(jax.random.uniform(k_fill)),
            "filters": shifts,
            "perceptors": [_jax_perceptor_draws(pk, s, num_cuts, aspect) for pk, s in zip(pks, cut_sizes)],
        })
    return out


@pytest.mark.parametrize("name", list(SLICES))
def test_plugin_slice_matches_jax_engine(tmp_path, monkeypatch, name):
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))  # no aesthetic head: the zero head in both
    cfg = dict(BASE, **SLICES[name])
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax")), apply_side_effects=False))
    weights = {p.name: state_dict_from_flax(p.variables["params"], p.config) for p in ref.perceptors}
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port")), apply_side_effects=False),
                  device="cpu", state_dicts=weights)
    port.z = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), ref.z)
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))
    cut_sizes = [p.input_resolution for p in port.perceptors]
    filters = [f for f, _ in port.filters]
    for it in range(cfg["iterations"]):
        _, k_step = jax.random.split(ref.key)
        draws = jax_step_draws(k_step, cut_sizes, cfg["num_cuts"], 48 / 32, cfg["batches"], filters,
                               (port.side_y, port.side_x))
        ref.train(it)
        port.train(it, draws)
        np.testing.assert_allclose(port.last_loss_values.numpy(), np.asarray(ref.last_loss_values), atol=1e-4)
        for got, want in zip(jax.tree_util.tree_leaves(port.z), jax.tree_util.tree_leaves(ref.z)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert port.loss_names == ref.loss_names == NAMES[name]
    port.cur_iteration = cfg["iterations"]
    port.run()  # the final checkin
    assert (tmp_path / "port" / "output.png").exists()


class _Recorder(LossInterface):
    seen = []

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        _Recorder.seen.append({k: v.detach().clone() for k, v in cur_cutouts.items()})
        return out.new_zeros(())


def test_losses_see_the_last_bank_of_a_cut_size(tmp_path, monkeypatch):
    add_custom_loss("recorder_test_loss", _Recorder)
    banks = []
    bank = cuda_warp.cutout_bank

    def recording_bank(*a, **k):
        out = bank(*a, **k)
        banks.append(out.detach().clone())
        return out

    monkeypatch.setattr(cuda_warp, "cutout_bank", recording_bank)
    cfg = dict(BASE, **dict(SLICES["dwt_two_towers_one_size"], custom_loss="recorder_test_loss"), outdir=str(tmp_path))
    port = Engine(apply_settings(cfg, apply_side_effects=False), device="cpu")
    _Recorder.seen.clear()
    port.train(0)
    assert len(banks) == 2 and len(_Recorder.seen) == 1 and list(_Recorder.seen[0]) == [32]
    assert torch.equal(_Recorder.seen[0][32], banks[1].permute(0, 2, 3, 1).float())
    assert not torch.equal(banks[0], banks[1])
    assert port.loss_names[-1] == "loss:_Recorder"


@pytest.mark.parametrize("recipe", ["tiler_fft", "tiler_fft_shift", "tiler_pixel", "tiler_pixel_shift"])
def test_tiler_recipes_resolve_like_jax(recipe):
    settings = {"config_file": os.path.join(REPO, "cogs", f"{recipe}.yaml"), "prompts": "a tiled pattern"}
    port = vars(apply_settings(dict(settings), apply_side_effects=False))
    ref = vars(j_apply_settings(dict(settings), apply_side_effects=False))
    assert port == ref
    assert port["filters"] == "wallpaper"
    port = vars(apply_settings(dict(settings, clip_models="ViT-B/32,ViT-B/16"), apply_side_effects=False))
    assert port["clip_models"] == ["ViT-B/32", "ViT-B/16"]
