"""The prompt kinds that reduce to table rows at init, against the JAX
package on the CPU: ``build_prompt_tables`` with target images (encoded
once through ``encode_image``), spot and spot_off text prompts, ImageNet
labels and noise prompts (rows of the last perceptor), on TinyTest and
TinyTest48 with the JAX towers' weights bridged; every table's embeddings,
weights and stops to 1e-4 (the towers sum in other orders, ~1e-6), the
row counts and order equal; the clip embedding of a drawer that names a
tower (the cc12m diffusion models' conditioning) to 1e-5.  Also ``encode_image`` (channels-last images
in, the port's channel-major tower) and ``single_prompt_loss`` with its
gradient, against the JAX functions, to 1e-5.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pixray_tpu.engine.prompts import IMAGENET_TEMPLATES as J_TEMPLATES
from pixray_tpu.engine.prompts import build_prompt_tables as j_tables
from pixray_tpu.engine.prompts import single_prompt_loss as j_single
from pixray_tpu.io.images import load_image_for_perceptor as j_load
from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu_torch.engine.prompts import IMAGENET_TEMPLATES, build_prompt_tables, single_prompt_loss
from pixray_tpu_torch.io.images import load_image_for_perceptor
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.perceptor import Perceptor

NAMES = ("TinyTest", "TinyTest48")


@pytest.fixture(scope="module")
def towers():
    ref = [JPerceptor(name, dtype=jnp.float32) for name in NAMES]
    port = [Perceptor(p.name, "cpu", torch.float32, state_dict_from_flax(p.variables["params"], p.config))
            for p in ref]
    return ref, port


@pytest.fixture
def pngs(tmp_path):
    out = []
    for i, shape in enumerate(((40, 70, 3), (64, 52, 3))):
        path = tmp_path / f"target{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(0, 256, shape, dtype=np.uint8)).save(path)
        out.append(str(path))
    return out


def _args(**kw):
    base = dict(prompts=[], vector_prompts=[], spot_prompts=[], spot_prompts_off=[], labels=[],
                noise_prompt_seeds=[], noise_prompt_weights=[], animation_dir=None)
    return SimpleNamespace(**dict(base, **kw))


def _assert_tables_equal(port, ref, atol):
    assert set(port) == set(ref)
    for name in ref:
        assert port[name].size == ref[name].size
        for field in ("embeds", "weights", "stops"):
            np.testing.assert_allclose(getattr(port[name], field).numpy(), np.asarray(getattr(ref[name], field)),
                                       atol=atol, err_msg=f"{name} {field}")


CASES = {
    "targets_and_text": dict(prompts=["sunrise", "a barn:0.5"], targets=[(0, 1.0, float("-inf")),
                                                                         (1, 0.5, -0.2)]),
    "spots": dict(prompts=["sunrise"], spot_prompts=["a face", "eyes:2"], spot_prompts_off=["sky:0.5:-1"]),
    "labels": dict(prompts=["sunrise"], labels=["fox", "red barn:0.3"]),
    "noise": dict(prompts=["sunrise"], noise_prompt_seeds=[3, 11], noise_prompt_weights=[0.5, -0.25]),
    # under animation the target images fill the target table, one row per frame
    "animation_targets": dict(prompts=["sunrise"], targets=[(0, 1.0, float("-inf")), (1, 0.5, -0.2)],
                              animation_dir="anim"),
    # a drawer conditioned on a perceptor's embedding (the cc12m diffusion
    # models): the weighted sum of that tower's target-image and text rows
    "clip_embed": dict(prompts=["sunrise", "=a barn:0.5", "sky:-0.3"], targets=[(1, 0.7, float("-inf"))],
                       drawer="TinyTest48"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prompt_tables_match_jax(towers, pngs, case):
    kw = dict(CASES[case])
    targets = [(pngs[i], w, s) for i, w, s in kw.pop("targets", [])] or None
    ref_p, port_p = towers
    drawer = SimpleNamespace(clip_model=kw.pop("drawer")) if "drawer" in kw else None
    args = _args(**kw)
    ref = j_tables(args, ref_p, drawer=drawer, target_image_paths=targets)
    port = build_prompt_tables(args, port_p, target_image_paths=targets, drawer=drawer)
    assert len(port) == len(ref) == 5
    for got, want in zip(port, ref[:4]):
        _assert_tables_equal(got, want, atol=1e-4)
    # the animation's target table: its targets' rows, empty without animation; the clip embedding only
    # for a drawer that names a tower
    frames = len(targets or []) if kw.get("animation_dir") else 0
    assert all(t.size == frames for t in port[3].values())
    if drawer is None:
        assert port[4] is None and ref[4] is None
    else:
        assert port[4].shape == ref[4].shape == (1, 32)
        np.testing.assert_allclose(port[4], np.asarray(ref[4]), atol=1e-5)
    main = port[0]
    rows = len(kw.get("prompts", [])) + len(targets or []) - frames + len(kw.get("labels", []))
    assert main["TinyTest"].size == rows
    # noise prompts are rows of the last perceptor only
    assert main["TinyTest48"].size == rows + len(kw.get("noise_prompt_seeds", []))
    assert port[1]["TinyTest"].size == len(kw.get("spot_prompts", []))
    assert port[2]["TinyTest48"].size == len(kw.get("spot_prompts_off", []))


def test_labels_templates_are_jaxs():
    assert IMAGENET_TEMPLATES == J_TEMPLATES


@pytest.mark.parametrize("tower", range(len(NAMES)))
def test_encode_image_matches_jax(towers, pngs, tower):
    ref, port = towers[0][tower], towers[1][tower]
    imgs = np.stack([load_image_for_perceptor(p, port.input_resolution) for p in pngs])
    np.testing.assert_array_equal(imgs, np.stack([j_load(p, ref.input_resolution) for p in pngs]))
    got = port.encode_image(imgs)
    want = ref.encode_image(imgs)
    assert got.shape == (2, port.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("weight", [1.0, 0.4, -0.7, 0.0])
def test_single_prompt_loss_matches_jax(weight):
    rng = np.random.default_rng(2)
    iii = rng.standard_normal((8, 16)).astype(np.float32)
    embed = rng.standard_normal((5, 16)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: j_single(x, jnp.asarray(embed), weight), jnp.asarray(iii))
    x = torch.tensor(iii, requires_grad=True)
    out = single_prompt_loss(x, torch.tensor(embed), weight)
    (g,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(out.item(), float(ref), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.ones(()))[0]), atol=1e-5)
