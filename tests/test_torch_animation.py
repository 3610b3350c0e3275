"""The animation ring (``--animation_dir``) in the port against the JAX engine, on the CPU.

- ``_anim_filelist`` against the JAX engine's over its four sources
  (overlay, target, init and prompt images), each the longest in turn:
  the list and the lines it prints.
- ``_block_size`` and ``_has_host_event`` with ``cur_anim_index`` set,
  against the JAX engine's on the stub of tests/test_torch_blocks.py: a
  block ends with its frame's ``save_every`` span.
- The animation slice: pixel 48x32, TinyTest, 8 cuts, two frames (init,
  image-prompt and target image globs of two PNGs each), ``save_every``
  2, 4 iterations, against the JAX engine with its draws replayed in the
  port (the frame's image-prompt bank draws as image prompt 0 does:
  ``k_imgs[0]`` and, shuffled, ``fold_in(k_imgs[-1], 0)``): per-step
  losses within 1e-4, the ``image_prompt_frame`` and ``target_frame``
  terms, the init composites equal, the blend between the rounds (the
  port's own equal to the JAX engine's but at under 0.1% of its values:
  the latent elements that Adam steps apart by up to twice the learning
  rate, as tests/test_torch_image_slice.py bounds them), the frame PNGs
  and ``anim.gif``.  Each re-encoding (a frame's
  init image, each blend) starts from the JAX engine's image, and the
  port's latent is held within 2e-3 of the JAX engine's (the pixel
  drawer's box means from an f32 integral image, whose two cumsums round
  apart: tests/test_torch_pixel.py), then continues from the JAX
  engine's, as the image slice's overlay test continues from its canvas.
- The blocked animation (``--steps_per_call`` 4: 4-step blocks inside
  5-step spans, two rounds with the blend between them) bitwise the
  single-step one: per-step losses, each frame's latent, the frame PNGs;
  no block crosses a span.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.latent import leaves
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from test_torch_blocks import _args, _idat, _Stub
from test_torch_image_slice import jax_image_draws, write_png
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")


# ------------------------------------------------------------------ the frame list
@pytest.mark.parametrize("longest", ["overlay", "target", "init", "prompt", "tie"])
def test_anim_filelist_matches_jax(tmp_path, capsys, longest):
    counts = dict(overlay=2, target=2, init=2, prompt=2)
    if longest != "tie":
        counts[longest] = 3
    for kind, n in counts.items():
        for i in range(n):
            write_png(tmp_path / f"{kind}{i}.png", (8, 8, 3), "RGB", i)
    glob = lambda kind: str(tmp_path / f"{kind}*.png")
    prompts = sorted(str(p) for p in tmp_path.glob("prompt*.png"))
    args = SimpleNamespace(overlay_image=glob("overlay"), target_images=[glob("target") + ":0.5"],
                           init_image=glob("init"), image_prompts=prompts)
    stub = SimpleNamespace(args=args)
    got = Engine._anim_filelist(stub)
    port_out = capsys.readouterr().out
    want = JEngine._anim_filelist(stub)
    assert got == want and len(got) == (2 if longest == "tie" else 3)
    assert port_out == capsys.readouterr().out
    assert os.path.basename(got[0]).startswith("overlay" if longest == "tie" else longest)


# ------------------------------------------------------------------ scheduling
@pytest.mark.parametrize("steps_per_call", [0, 4])
def test_block_size_with_a_frame_matches_jax(steps_per_call):
    cases = 0
    for iterations, save_every in ((20, 10), (37, 6), (24, 8)):
        for frame in (0, 1):
            stub = _Stub(_args(iterations, save_every, [], steps_per_call, False, display_every=100), False)
            stub.cur_anim_index = frame
            for it in range(iterations + 1):
                n = Engine._block_size(stub, it)
                assert n == JEngine._block_size(stub, it), (iterations, save_every, it)
                assert Engine._has_host_event(stub, it) == JEngine._has_host_event(stub, it)
                assert it % save_every + n <= save_every or n == 1  # never across the frame's span
                cases += 1
    assert cases == 2 * (21 + 38 + 25)


# ------------------------------------------------------------------ the slice against JAX
ANIM = dict(
    drawer="pixel", prompts="sunrise", clip_models="TinyTest", size=[48, 32], num_cuts=8, batches=1,
    iterations=4, save_every=2, display_every=100000, init_noise="pixels", vector_prompts="none", seed=1,
    save_intermediates=False, learning_rate_drops=[], precision="fp32", shard_cutouts=False, steps_per_call=1,
    init_image_alpha=120, animation_alpha=100,
)


def _inputs(tmp_path):
    for i in range(2):
        write_png(tmp_path / f"init{i}.png", (40, 60, 3), "RGB", 10 + i)
        write_png(tmp_path / f"prompt{i}.png", (30, 30, 3), "RGB", 20 + i)
        write_png(tmp_path / f"target{i}.png", (33, 45, 3), "RGB", 30 + i)
    return dict(init_image=str(tmp_path / "init*.png"), image_prompts=str(tmp_path / "prompt*.png"),
                target_images=str(tmp_path / "target*.png"))


@pytest.mark.parametrize("shuffle", [False, True], ids=["same_cuts", "shuffle"])
def test_animation_slice_matches_jax_engine(tmp_path, shuffle):
    cfg = dict(ANIM, image_prompt_shuffle=shuffle, **_inputs(tmp_path))
    for label in ("jax", "port"):
        (tmp_path / label).mkdir()
    ref = JEngine(j_apply_settings(dict(cfg, outdir=str(tmp_path / "jax"),
                                        animation_dir=str(tmp_path / "jax" / "anim")), apply_side_effects=False))
    jp = ref.perceptors[0]
    port = Engine(apply_settings(dict(cfg, outdir=str(tmp_path / "port"), animation_dir=str(tmp_path / "port" / "anim")),
                                 apply_side_effects=False), device="cpu",
                  state_dicts={"TinyTest": state_dict_from_flax(jp.variables["params"], jp.config)})
    assert len(port.init_image_rgba_list) == len(ref.init_image_rgba_list) == 2
    for a, b in zip(port.init_image_rgba_list, ref.init_image_rgba_list):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    spec = port.step_cfg.perceptors[0]
    assert spec.image_prompt_frame and spec.n_image_prompts == 1 and spec.banks == 2
    assert spec.target_table.size == 2 and spec.table.size == 1  # the targets are the frames' rows
    port.z = torch.tensor(np.asarray(ref.z))
    port.opt_state = port.optimizer.init(port.z)
    port.step_cfg.z_orig_flat = torch.tensor(np.asarray(ref.z_orig_flat))

    # the JAX run: each step's draws and losses, and every image it re-encodes
    draws, ref_losses, ref_frames, encoded = [], [], [], []
    j_train, j_reapply = ref.train, ref.reapply_from_image
    stand_in = SimpleNamespace(cut_size=32, spot_banks=(False, False), n_image_prompts=2)

    def j_recording_train(it):
        _, k_step = jax.random.split(ref.key)
        step_draws = jax_image_draws(k_step, [stand_in], cfg["num_cuts"], 48 / 32, 1, shuffle)
        for d in step_draws:
            d["perceptors"][0]["image_prompts"] = d["perceptors"][0]["image_prompts"][:1]
        draws.append(step_draws)
        out = j_train(it)
        ref_losses.append(np.asarray(ref.last_loss_values))
        ref_frames.append(ref.cur_anim_index)
        return out

    def j_recording_reapply(img):
        out = j_reapply(img)
        encoded.append((img.convert("RGB").copy(), np.asarray(ref.z).copy()))
        return out

    ref.train, ref.reapply_from_image = j_recording_train, j_recording_reapply
    assert ref.run()

    # the port's run, fed the JAX draws and re-encoding the JAX engine's images
    losses, frames, own = [], [], []
    p_train, p_reapply = port.train, port.reapply_from_image
    queue, images = iter(draws), iter(encoded)

    def p_recording_train(it, draws=None):
        out = p_train(it, draws)
        losses.append(port.last_loss_values.numpy().copy())
        frames.append(port.cur_anim_index)
        return out

    def p_replaying_reapply(img):
        want, z = next(images)
        own.append(np.abs(np.asarray(img.convert("RGB"), int) - np.asarray(want, int)))
        p_reapply(want)
        np.testing.assert_allclose(port.z.numpy(), z, atol=2e-3)
        port.z.copy_(torch.from_numpy(z))

    port.train, port.reapply_from_image = p_recording_train, p_replaying_reapply
    port.draw_step = lambda planes_out=None: next(queue)
    assert port.run()

    assert frames == ref_frames == [0, 0, 1, 1, 0, 0, 1, 1]
    assert len(losses) == len(ref_losses) == 8
    for step, (a, b) in enumerate(zip(losses, ref_losses)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"step {step}")
    assert port.loss_names == ref.loss_names == ["TinyTest:prompt0", "TinyTest:target_frame",
                                                 "TinyTest:image_prompt_frame"]
    assert len(own) == len(encoded) == 4  # each frame's init image, then each frame's blend
    for diff in own:  # the latents Adam stepped apart (see the docstring), through the uint8 blend
        assert (diff > 0).mean() < 1e-3 and diff.max() <= 2 * port.args.learning_rate * 255 + 1
    for label in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / label / "anim")) == ["anim.gif", "target0.png", "target1.png"]
    with Image.open(tmp_path / "port" / "anim" / "anim.gif") as im:
        assert im.n_frames == 2


def _anim_run(tmp_path, label, steps_per_call):
    outdir = tmp_path / label
    outdir.mkdir()
    cfg = dict(ANIM, iterations=10, save_every=5, steps_per_call=steps_per_call, outdir=str(outdir),
               animation_dir=str(outdir / "anim"), **_inputs(tmp_path))
    engine = Engine(apply_settings(cfg, apply_side_effects=False), device="cpu")
    losses = []
    train = engine.train

    def recording(it, draws=None):
        out = train(it, draws)
        losses.append(engine.last_loss_values.clone())
        return out

    engine.train = recording
    assert engine.run()
    pngs = {name: _idat(outdir / "anim" / name) for name in sorted(os.listdir(outdir / "anim")) if name != "anim.gif"}
    return engine, losses, pngs


def test_blocked_animation_equals_single_steps(tmp_path):
    blocked, b_losses, b_pngs = _anim_run(tmp_path, "blocked", 4)
    single, s_losses, s_pngs = _anim_run(tmp_path, "single", 1)
    # per span: the checkin step, then one block of 4
    assert blocked.dispatched_blocks == [(1, 4), (1, 4), (6, 4), (6, 4)] and single.dispatched_blocks == []
    assert len(b_losses) == len(s_losses) == 20
    for step, (a, b) in enumerate(zip(b_losses, s_losses)):
        assert torch.equal(a, b), step
    for zb, zs in zip(blocked.anim_cur_zs, single.anim_cur_zs):
        for a, b in zip(leaves(zb), leaves(zs)):
            assert torch.equal(a, b)
    assert sorted(b_pngs) == ["target0.png", "target1.png"]
    assert b_pngs == s_pngs  # the image data (the text chunks name the settings, which differ)
