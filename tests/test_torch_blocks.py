"""Blocked dispatch (``--steps_per_call``) in the port, on the CPU.

- ``Engine._block_size`` and ``_has_host_event`` against the JAX engine's,
  both called as unbound methods on one stub, over iterations, checkin
  cadences, LR drops, ``steps_per_call`` 0/1/4/8, ``auto_stop``, a drawer
  with ``post_step``, an overlay schedule and every ``cur_it``: equal.
- The parametrized pixel / clipdraw / fft runs, blocked against single
  steps, are in ``test_torch_block_runs.py`` (a file of its own, so that
  the two files run on two workers).
- Without filters a step draws exactly the stream it drew before (the
  fill, then the cuts); with filters the shifts come between the two, each
  in its own input's range; with spot, spot_off and image prompts their
  noise (and under shuffle the image prompts' cuts) follows each
  perceptor's main bank.
- A pixel run with an overlay inside the schedule (re-encoded before steps
  9 and 19, where a block ends and where the next one starts), image
  prompts, spot prompts, an image label and ``init_weight_pix``:
  ``steps_per_call`` 8 and 1 bitwise equal.
- The device-tensor Adam against the formula it replaced and against
  optax, 1e-6 each, as tests/test_torch_engine.py holds Adam: the bias
  corrections are now f32 ``pow`` on the device, where the host's integer
  power rounded otherwise (1 - 0.999^3 is one f32 ulp apart).
- The plain bank takes the fill from the parameter rows and gives what the
  fill argument gave: bitwise.
"""

import os
import struct
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixray_tpu.engine.core import Engine as JEngine
from pixray_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.core import Engine
from pixray_tpu_torch.engine.latent import leaves
from pixray_tpu_torch.engine.optimizers import Adam, PerGroupAdam, state_tensors
from pixray_tpu_torch.ops import cuda_warp
from pixray_tpu_torch.ops.warp_batch import warp_modes_plain
from torch_parity import jax_perceptor_cache  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")


# ------------------------------------------------------------------ scheduling
class _Stub:
    """What both engines' ``_block_size`` / ``_has_host_event`` read."""

    BLOCK_STEPS = 8
    _want = Engine._want

    def __init__(self, args, post_step):
        self.args = args
        self.drawer = SimpleNamespace(post_step=lambda z, it: None) if post_step else SimpleNamespace()
        self.cur_anim_index = None
        self._display_streaming = False


def _args(iterations, save_every, drops, steps_per_call, auto_stop, display_every=20, overlay=False):
    return SimpleNamespace(
        iterations=iterations, save_every=save_every, learning_rate_drops=drops,
        steps_per_call=steps_per_call, auto_stop=auto_stop, make_video=False, checkpoint_every=0,
        display_every=display_every, overlay_image="overlay.png" if overlay else None, overlay_every=10,
        overlay_offset=3, overlay_until=25,
    )


@pytest.mark.parametrize("steps_per_call", [0, 1, 4, 8])
@pytest.mark.parametrize("variant", ["plain", "auto_stop", "post_step", "overlay"])
def test_block_size_matches_jax(steps_per_call, variant):
    cases = 0
    for iterations in (5, 20, 37):
        for save_every in (1, 3, 10, 100000):
            for drops in ([], [7], [4, 15]):
                for display_every in (5, 20):
                    args = _args(iterations, save_every, drops, steps_per_call, variant == "auto_stop",
                                 display_every, variant == "overlay")
                    stub = _Stub(args, variant == "post_step")
                    for it in range(iterations + 1):
                        assert Engine._block_size(stub, it) == JEngine._block_size(stub, it), (args, it)
                        assert Engine._has_host_event(stub, it) == JEngine._has_host_event(stub, it), (args, it)
                        cases += 1
    assert cases == 2 * 3 * 4 * (6 + 21 + 38)


# ------------------------------------------------------------------ blocked vs single-step runs
RUN = dict(prompts="sunrise", clip_models="TinyTest", size=[64, 36], num_cuts=8, batches=1,
           iterations=24, save_every=10, learning_rate_drops=[50], seed=3, init_noise=None,
           vector_prompts="none", precision="fp32", save_intermediates=True)


def _idat(path):
    """The image data of a PNG (its text chunks name the settings, which differ)."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    return out


def _run(tmp_path, label, steps_per_call, **extra):
    outdir = tmp_path / label
    outdir.mkdir()
    engine = Engine(apply_settings(dict(RUN, outdir=str(outdir), steps_per_call=steps_per_call, **extra),
                                   apply_side_effects=False), device="cpu")
    losses = []
    it = 0
    while True:  # run()'s loop, reading each step's losses
        keep_going = engine.train(it)
        if it < engine.args.iterations:
            losses.append(engine.last_loss_values.clone())
        if it == engine.args.iterations or not keep_going:
            break
        it += 1
    frames = sorted(os.listdir(outdir / "steps"))
    images = {name: _idat(outdir / "steps" / name) for name in frames}
    images["output.png"] = _idat(outdir / "output.png")
    return engine, losses, images, engine.dispatched_blocks


def test_no_filter_run_draws_the_same_stream(tmp_path):
    """Without filters a step draws what it drew before filters existed:
    per batch the fill, then each perceptor's cuts, jitter and noise,
    nothing between them; with filters each batch draws its shifts between
    the fill and the cuts, in the range of the shape the filters before it
    leave."""
    from pixray_tpu_torch.engine import cutouts as C

    engine = Engine(apply_settings(dict(RUN, drawer="pixel", batches=2, outdir=str(tmp_path)),
                                   apply_side_effects=False), device="cpu")
    gen, gen_dev = torch.Generator(), torch.Generator()
    gen.set_state(engine.gen.get_state())
    gen_dev.set_state(engine.gen_device.get_state())
    draws = engine.draw_step()
    for d in draws:
        assert d["fill"] == float(torch.rand((), generator=gen)) and d["filters"] == []
        want = C.draw_step_cutouts(gen, gen_dev, RUN["num_cuts"], 32, engine.args.aspect_width, torch.float32,
                                   torch.device("cpu"))
        for got, ref in zip(d["perceptors"][0]["transforms"] + d["perceptors"][0]["jitter"],
                            want["transforms"] + want["jitter"]):
            assert torch.equal(got, ref)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=engine.gen))

    engine = Engine(apply_settings(dict(RUN, drawer="pixel", filters="wallpaper,tiler", wallpaper_type="shift",
                                        outdir=str(tmp_path)), apply_side_effects=False), device="cpu")
    gen = torch.Generator()
    gen.set_state(engine.gen.get_state())
    for _ in range(20):
        d = engine.draw_step()[0]
        assert d["fill"] == float(torch.rand((), generator=gen))
        (wh, ww), (th, tw) = d["filters"]
        assert 0 <= wh < engine.side_y and 0 <= ww < engine.side_x  # wallpaper: its input
        assert 0 <= th < 2 * engine.side_y and 0 <= tw < engine.side_x  # tiler: the doubled rows
        assert (wh, ww) == (int(torch.randint(0, engine.side_y, (), generator=gen)),
                            int(torch.randint(0, engine.side_x, (), generator=gen)))
        assert (th, tw) == (int(torch.randint(0, 2 * engine.side_y, (), generator=gen)),
                            int(torch.randint(0, engine.side_x, (), generator=gen)))
        C.draw_step_cutouts(gen, torch.Generator(), RUN["num_cuts"], 32, engine.args.aspect_width, torch.float32,
                            torch.device("cpu"))


def _png(path, shape, mode, seed):
    from PIL import Image

    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8), mode).save(path)
    return str(path)


def test_image_banks_draw_after_the_main_bank():
    """Per perceptor: the main bank's cuts, jitter and noise, then the spot
    noise, the spot_off noise, and per image prompt its cuts (under
    shuffle only) and noise; a perceptor without them draws the main bank's
    stream alone."""
    gens = [torch.Generator().manual_seed(9) for _ in range(4)]
    plain = C.draw_step_cutouts(gens[0], gens[1], 8, 24, 1.5, torch.float32, "cpu")
    full = C.draw_step_cutouts(gens[2], gens[3], 8, 24, 1.5, torch.float32, "cpu", spot=True, spot_off=True,
                               image_prompts=2, shuffle=True)
    assert sorted(plain) == ["jitter", "noise", "transforms"]
    for a, b in zip(plain["transforms"] + plain["jitter"], full["transforms"] + full["jitter"]):
        assert torch.equal(a, b)
    assert torch.equal(plain["noise"][0], full["noise"][0])
    # what follows in the host stream, drawn by hand
    g, g_dev = gens[0], gens[1]
    noise = lambda: C.draw_noise(g, g_dev, 8, 24, torch.float32, "cpu")
    for key in ("spot", "spot_off"):
        facs, planes = noise()
        assert torch.equal(full[key][0], facs) and all(torch.equal(a, b) for a, b in zip(full[key][1], planes))
    for ip in full["image_prompts"]:
        want = C.cut_transforms(C.draw_cut_params(g, 8, 1.5), 24, 1.5)
        assert all(torch.equal(a, b) for a, b in zip(ip["transforms"], want))
        assert torch.equal(ip["noise"][0], noise()[0])
    banks = C.draw_banks(full)
    assert len(banks) == 5 and all(b[1] is None for b in banks[1:])
    assert banks[1][0] is full["transforms"] and banks[3][0] is full["image_prompts"][0]["transforms"]
    # into given planes, bank after bank
    out = [torch.zeros((40, 24, 24)) for _ in range(3)]
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    into = C.draw_step_cutouts(*gens, 8, 24, 1.5, torch.float32, "cpu", planes_out=out, spot=True, spot_off=True,
                               image_prompts=2)
    assert into["image_prompts"][1]["transforms"] is None
    assert torch.equal(out[2][16:24], into["spot_off"][1][2]) and torch.equal(out[0][32:], into["image_prompts"][1]["noise"][1][0])


def test_blocked_image_run_with_overlay_equals_single_steps(tmp_path):
    extra = dict(drawer="pixel", save_every=100000, learning_rate_drops=[], display_every=100000,
                 overlay_image=_png(tmp_path / "overlay.png", (20, 30, 4), "RGBA", 1), overlay_every=10,
                 overlay_offset=9, image_prompts=_png(tmp_path / "prompt.png", (30, 30, 3), "RGB", 2),
                 spot_prompts="a face", spot_prompts_off="sky", image_labels=_png(tmp_path / "label.png",
                                                                                  (36, 64, 3), "RGB", 3),
                 init_image=_png(tmp_path / "init.png", (40, 50, 3), "RGB", 4), init_weight_pix=0.5,
                 save_intermediates=False)
    runs = {}
    for label, spc in (("blocked", 8), ("single", 1)):
        outdir = tmp_path / label
        outdir.mkdir()
        engine = Engine(apply_settings(dict(RUN, outdir=str(outdir), steps_per_call=spc, **extra),
                                       apply_side_effects=False), device="cpu")
        overlays = []
        rewrite = engine.re_average_z
        engine.re_average_z = lambda e=engine, r=rewrite, o=overlays: (o.append(e.cur_iteration), r())
        losses = []
        for it in range(engine.args.iterations + 1):
            engine.cur_iteration = it
            keep_going = engine.train(it)
            if it < engine.args.iterations:
                losses.append(engine.last_loss_values.clone())
            if not keep_going:
                break
        runs[label] = (engine, losses, overlays)
    (blocked, b_losses, b_over), (single, s_losses, s_over) = runs["blocked"], runs["single"]
    # the overlay before step 9 ends the first block and starts the second
    assert b_over == s_over == [9, 19]
    assert blocked.dispatched_blocks == [(1, 8), (9, 8)] and single.dispatched_blocks == []
    assert blocked.step_block.cut_counts == [8 * 4]  # main, spot, spot_off, one image prompt
    assert blocked.loss_names == single.loss_names == [
        "TinyTest:prompt0", "TinyTest:spot0", "TinyTest:spot_off0", "TinyTest:image_prompt0", "image_label0",
        "init_weight_pix"]
    for it, (a, b) in enumerate(zip(b_losses, s_losses)):
        assert torch.equal(a, b), it
    assert torch.equal(blocked.z, single.z)
    for a, b in zip(state_tensors(blocked.opt_state), state_tensors(single.opt_state)):
        assert torch.equal(a, b)


def test_explicit_draws_step_eagerly(tmp_path, monkeypatch):
    """``train(it, draws=...)`` is one eager step even where a block would start."""
    engine = Engine(apply_settings(dict(RUN, drawer="pixel", outdir=str(tmp_path), save_every=100000),
                                   apply_side_effects=False), device="cpu")
    monkeypatch.setattr(engine, "_dispatch_block", lambda *a: pytest.fail("dispatched a block"))
    for it in range(3):
        engine.train(it, engine.draw_step())
    assert engine.steps_dispatched == 3 and engine.step_block is None


# ------------------------------------------------------------------ Adam on device tensors
def _old_adam(z, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The formula the port's Adam used before its state moved to the device."""
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    out = []
    for count, g in enumerate(grads, start=1):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        z = z + -lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps))
        out.append(z)
    return out


def test_device_adam_matches_old_formula_and_optax():
    rng = np.random.default_rng(5)
    z0 = rng.random((40, 4)).astype(np.float32)
    grads = [rng.standard_normal((40, 4)).astype(np.float32) * s for s in (1.0, 1e-3, 5.0, 0.2, 30.0)]
    old = _old_adam(torch.tensor(z0), [torch.tensor(g) for g in grads], 0.03)
    opt = Adam(0.03)
    z = torch.tensor(z0)
    state = opt.init(z)
    assert state.count.dtype == torch.int32 and state.count.shape == ()
    ref = j_build_optimizer("Adam", 0.03)
    jstate = ref.init(jnp.asarray(z0))
    jz = jnp.asarray(z0)
    addresses = [t.data_ptr() for t in state_tensors(state)]
    for g, z_old in zip(grads, old):
        upd, same = opt.update(torch.tensor(g), state)
        assert same is state
        z = z + upd
        np.testing.assert_allclose(z.numpy(), z_old.numpy(), atol=1e-6)
        jupd, jstate = ref.update(jnp.asarray(g), jstate, jz)
        jz = optax.apply_updates(jz, jupd)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    assert int(state.count) == len(grads)
    assert [t.data_ptr() for t in state_tensors(state)] == addresses  # updated in place
    opt.reset(state)
    fresh = opt.init(z)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(state), state_tensors(fresh)))
    assert [t.data_ptr() for t in state_tensors(state)] == addresses


def test_per_group_adam_resets_in_place():
    opt = PerGroupAdam({"a": 1.0, "b": 0.1})
    params = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    state = opt.init(params)
    opt.update({"a": torch.full((3,), 0.5), "b": torch.full((2, 2), -2.0)}, state)
    assert int(state["a"].count) == int(state["b"].count) == 1
    before = [t.data_ptr() for t in state_tensors(state)]
    opt.reset(state)
    assert [t.data_ptr() for t in state_tensors(state)] == before
    assert not any(bool(t.any()) for k in state for t in (state[k].count, state[k].mu, state[k].nu))
    assert float(state["a"].learning_rate) == 1.0 and float(state["b"].learning_rate) == np.float32(0.1)


# ------------------------------------------------------------------ the fill in the parameter rows
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_bank_reads_fill_from_rows(dtype):
    gen = torch.Generator().manual_seed(4)
    draws = C.draw_step_cutouts(gen, torch.Generator().manual_seed(4), 10, 24, 96 / 54,
                                dtype or torch.float32, "cpu")
    work = torch.rand((24, 24, 3), generator=gen)
    fill = float(torch.rand((), generator=gen))
    params = C.pack_cutouts(draws["transforms"], reflect_padding=False, fill_color=fill,
                            jitter=draws["jitter"], facs=draws["noise"][0])
    assert torch.equal(params[:, 14], torch.full((10,), fill))
    out = cuda_warp.cutout_bank_plain(work, params, 24, draws["noise"][1], dtype)
    # the composition with the fill as an argument, as the bank took it before
    p = cuda_warp.unpack_params(params)
    before = warp_modes_plain(work, p["inv"], p["modes"], fill, 24)
    if dtype is not None:
        before = before.to(dtype)
    before = cuda_warp.bank_epilogue_plain(before, params, draws["noise"][1])
    assert torch.equal(out, before)
    kw = dict(reflect_padding=False, fill_color=fill, jitter=draws["jitter"], noise=draws["noise"],
              compute_dtype=dtype)
    assert torch.equal(C.render_cutouts(work, draws["transforms"], 24, **kw), before)
