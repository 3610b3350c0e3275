"""The operation and byte counters against hand counts at ViT-B/32's
sizes, at the flagship cutout bank, and the decoder's convolutions against
a count taken from the reference module itself."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import cell as C
from portbench.harness import counts
from portbench.reference import towers
from portbench.reference.vqgan import VQGAN


def test_vit_b32_by_hand():
    d = C.load("pixel.steady").config["towers"]["ViT-B/32"]
    t, w = 50, 768  # 7x7 patches and the class token; width
    per_block = 2 * t * w * (3 * w) + 2 * t * w * w + 2 * (2 * t * w * (4 * w))  # qkv, out, two MLP layers
    linear = 2 * 49 * (3 * 32 * 32) * w + 12 * per_block + 2 * w * 512  # patches, 12 blocks, projection
    attention = 12 * (2 * t * t * w + 2 * t * t * w)  # scores and values
    f = towers.module("vit").image_flops(d)
    assert f == {"linear": linear, "attention": attention}
    # the input gradient: once more every product with a constant operand, twice each attention product
    assert counts.tower_step_flops(d, 64) == 64 * (2 * linear + 3 * attention) == 1_134_553_989_120


def test_flagship_bank_by_hand():
    n, jittered, s = 64, 47, 224
    plane, work, rows = s * s * 2, s * s * 3 * 4, n * 16 * 4
    k1_bytes = work + rows + 3 * n * plane * 2 + 3 * jittered * plane  # canvas, rows, noise in, bank out, pre-jitter out
    k2_bytes = 3 * n * plane + 3 * jittered * plane + rows + work  # cotangent, pre-jitter in, rows, canvas gradient out
    assert (k1_bytes, k2_bytes) == (53_291_008, 34_023_424)  # 53.3 MB and 34.0 MB
    fwd, bwd = counts.bank_bound_s(n, jittered, s, (s, s))
    assert fwd == pytest.approx(k1_bytes / 3.35e12) and bwd == pytest.approx(k2_bytes / 3.35e12)
    assert (55 * n + 45 * jittered) * s * s / 67e12 < fwd  # bytes bound it, not operations


def test_decoder_convolutions_match_the_module():
    d = C.load("vqgan.steady").config["vqgan"]
    h, w = 208, 384
    with torch.device("meta"):
        model = VQGAN(d)
    seen = []

    def hook(mod, inp, out):
        seen.append(2 * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1] * out.shape[1] * out.shape[2]
                    * out.shape[3])

    for m in list(model.decoder.modules()) + [model.post_quant_conv]:
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    z = torch.empty((1, d["embed_dim"], h // 16, w // 16), device="meta")
    model.decoder(model.post_quant_conv(z))
    f = counts.decoder_forward_flops(d, h, w)
    assert f["conv"] == sum(seen)
    tokens = (h // 16) * (w // 16)
    # four attention blocks at the lowest level (the middle's and one after each of its three resnets),
    # 512 channels: scores and values, 2 * tokens^2 * 512 each
    assert f["attention"] == 4 * (4 * tokens * tokens * 512)
    assert f["distance"] == 2 * tokens * 16384 * 256


def test_step_flops_add_towers_and_drawer():
    s = C.reference_settings(C.load("vqgan.steady"))
    towers = sum(counts.tower_step_flops(s["towers"][t], 64) for t in s["clip_models"])
    assert counts.step_flops(s) == towers + counts.decoder_step_flops(s["vqgan_dims"], 208, 384)


def test_step_mfu_reads_the_untraced_window():
    from types import SimpleNamespace

    cell = C.load("pixel.steady")
    settings = C.reference_settings(cell)
    # 119 steps in a 1 s window: 119 x the step's FLOPs over the bf16 peak
    run = SimpleNamespace(settings=settings, prog=SimpleNamespace(attempted=119, window_s=1.0), trace=None)
    mfu = C.reader("step_mfu_pct").read(run)
    assert mfu == pytest.approx(100 * 119 * counts.step_flops(settings) / 989e12)
    assert 13.0 < mfu < 14.0  # 1.135 TFLOP a step at 119 steps/s
