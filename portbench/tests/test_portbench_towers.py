"""Image towers by kind, and the weights and counts they give.

A tower kind added as a file to a checkout's ``reference/towers/`` is
found by the name its configuration gives (``vision_kind``), built into
the CLIP model, given weights by its own rule and counted by its own
FLOPs; the ViT, the kind of every configuration that names none, gives
the weights and counts that the benchmark's cells were measured with:
the tiny cells' weights to the SHA-256 digest taken before towers had
kinds, and the full configurations' tensor layout (names, shapes and
initialisers in state-dict order) and step FLOPs likewise.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os

import pytest
import torch
from conftest_tiny import tiny_checkout

from portbench.harness import cell as C
from portbench.harness import counts
from portbench.harness import weights as W
from portbench.reference import clip as RCLIP
from portbench.reference import towers

SEED = 2200000123

TOY = '''"""A toy image tower: a strided convolution, a mean pool and a projection."""

import torch
from torch import nn


class Visual(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.stem = nn.Conv2d(3, d["vision_width"], d["vision_patch_size"], stride=d["vision_patch_size"])
        self.proj = nn.Parameter(torch.empty(d["vision_width"], d["embed_dim"]))

    def forward(self, x):
        return self.stem(x).mean((2, 3)) @ self.proj


def init_rule(name, shape, d):
    if name == "stem.bias":
        return ("zeros",)
    if name == "stem.weight":
        return ("normal", 0.5)
    return ("ones",)


def image_flops(d):
    grid = (d["image_resolution"] // d["vision_patch_size"]) ** 2
    linear = 2 * grid * 3 * d["vision_patch_size"] ** 2 * d["vision_width"] + 2 * d["vision_width"] * d["embed_dim"]
    return {"linear": linear, "attention": 7}
'''


def _digest(weights: dict) -> str:
    h = hashlib.sha256()
    for model, sd in weights.items():
        for k, t in sd.items():
            h.update(f"{model}/{k}/{tuple(t.shape)}".encode())
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _layout(settings: dict) -> str:
    """The digest of every model's (name, key, shape, initialiser) in state-dict order."""
    h = hashlib.sha256()
    for name in settings["clip_models"]:
        d = settings["towers"][name]
        with torch.device("meta"):
            module = RCLIP.CLIP(d)
        for k, v in module.state_dict().items():
            h.update(repr((name, k, tuple(v.shape), RCLIP.init_rule(k, tuple(v.shape), d))).encode())
    drawer = importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}")
    if hasattr(drawer, "model"):
        with torch.device("meta"):
            key, module, d = drawer.model(settings)
        for k, v in module.state_dict().items():
            h.update(repr((key, k, tuple(v.shape), drawer.init_rule(k, tuple(v.shape), d))).encode())
    return h.hexdigest()


def test_a_tower_kind_added_as_a_file_is_found_built_given_weights_and_counted(tmp_path):
    root, bench_dir = tiny_checkout(tmp_path)
    os.makedirs(os.path.join(bench_dir, "reference", "towers"))
    with open(os.path.join(bench_dir, "reference", "towers", "toy.py"), "w") as f:
        f.write(TOY)
    path = os.path.join(bench_dir, "configs", "tiny_pixel.json")
    config = json.load(open(path))
    config["towers"]["TinyTest"]["vision_kind"] = "toy"
    json.dump(config, open(path, "w"))

    settings = C.reference_settings(C.load("tiny.pixel", root, bench_dir))
    d = settings["towers"]["TinyTest"]
    model = RCLIP.CLIP(d, settings["bench_dir"])
    assert type(model.visual).__name__ == "Visual" and hasattr(model.visual, "stem")
    assert [k for k in model.state_dict() if k.startswith("visual.")] == ["visual.proj", "visual.stem.weight",
                                                                          "visual.stem.bias"]

    weights = W.make(settings, SEED, "cpu")["TinyTest"]
    assert torch.equal(weights["visual.proj"], torch.ones(64, 32))
    assert torch.equal(weights["visual.stem.bias"], torch.zeros(64))
    assert 0.4 < float(weights["visual.stem.weight"].std()) < 0.6
    assert weights["token_embedding.weight"].std() < 0.03  # the text tower keeps its own rule
    model.load_state_dict(weights)
    emb = model.encode_image(torch.rand(5, 3, 32, 32))
    assert emb.shape == (5, 32)

    linear = 2 * 16 * 3 * 64 * 64 + 2 * 64 * 32
    assert counts.tower_step_flops(d, 8, settings["bench_dir"]) == 8 * (2 * linear + 3 * 7)
    drawer = importlib.import_module("portbench.reference.drawers.pixel")
    assert counts.step_flops(settings) == 8 * (2 * linear + 3 * 7) + drawer.synth_flops(settings)
    # the toy is the checkout's own: the benchmark's folder has no such kind
    with pytest.raises(KeyError):
        towers.module("toy")


def test_a_tower_without_a_kind_is_a_vit():
    d = C.load("pixel.steady").config["towers"]["ViT-B/32"]
    assert "vision_kind" not in d and towers.kind_of(d) == "vit"
    with torch.device("meta"):
        assert type(RCLIP.CLIP(d).visual) is towers.module("vit").Visual


# digests of W.make's weights at SEED, taken before the towers had kinds
TINY_DIGESTS = {"tiny.pixel": "23e235f337299714159ce22e4c8cb3ec830b2a79403b6f8c82c2882a23f9929d",
                "tiny.vqgan": "b9acc7c03833476797836436ea7fd0a32f2c47c671bc7ebeae4d01e10591411a"}


@pytest.mark.parametrize("name", sorted(TINY_DIGESTS))
def test_tiny_weights_are_unchanged(tmp_path, name):
    root, bench_dir = tiny_checkout(tmp_path)
    settings = C.reference_settings(C.load(name, root, bench_dir))
    assert _digest(W.make(settings, SEED, "cpu")) == TINY_DIGESTS[name]


# the full configurations' tensor layouts and step FLOPs, taken before the towers had kinds
FULL = {"pixel.steady": ("d59769aa5c0dd75c735d2dce040e818d2333b1e524f96d6b19f359030761fd4c", 1_134_672_599_040),
        "vqgan.steady": ("c0d7b2fcd051e4ae44da037164cb6841e69a2f66d1a409d69c1597b857fc9569", 6_342_136_037_376)}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_configurations_keep_their_weights_and_flops(name):
    settings = C.reference_settings(C.load(name))
    layout, flops = FULL[name]
    assert _layout(settings) == layout
    assert counts.step_flops(settings) == flops
