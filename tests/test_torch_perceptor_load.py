"""Perceptor checkpoints in the port: the full-width layouts, the files it
finds on disk, and the quality × perceptors presets.

- Every full-width tower of ``CLIP_CONFIGS`` and ``SLIP_CONFIGS``, built on
  the meta device (no memory), has exactly the state-dict keys and shapes
  of the upstream checkpoint (``pixray_tpu/models/signatures.py``; a SLIP
  file's after the loader's renaming).
- A tiny file the test writes under ``$PIXRAY_TPU_MODELS`` in each layout
  (an OpenAI TorchScript archive with fp16 weights, an OpenAI plain state
  dict of a ResNet with ``num_batches_tracked``, a HuggingFace CLIPModel, a
  SLIP ``module.``-prefixed DDP file) is found by the JAX package's file
  name and loads to the weights the JAX converter makes of the same dict,
  bitwise.
- Every quality × perceptors preset resolves to the JAX package's
  ``clip_models``.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pixray_tpu.config import apply_settings as j_apply_settings
from pixray_tpu.config.settings import QUALITY_TO_CLIP_MODELS as J_PRESETS
from pixray_tpu.models import signatures
from pixray_tpu.models.clip.convert import convert_hf_clip, convert_openai_clip, convert_slip_clip
from pixray_tpu.models.perceptor import Perceptor as JPerceptor
from pixray_tpu_torch.config import apply_settings
from pixray_tpu_torch.models import perceptor as P
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.models.clip.checkpoint import slip_name
from pixray_tpu_torch.models.clip.configs import CLIP_CONFIGS, SLIP_CONFIGS
from pixray_tpu_torch.models.clip.model import CLIP
from torch_parity import randomize_batch_norms, tiny_towers  # noqa: F401

FULL_WIDTH = [n for n in CLIP_CONFIGS if not n.startswith("Tiny")] + list(SLIP_CONFIGS)


def _shape_only_adder(sd, rng):
    """signatures' ``add`` without the random draw: a zero-stride array of the shape."""
    def add(name, *shape):
        sd[name] = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape, (0,) * len(shape))

    return add


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_full_width_layout_is_the_upstream_checkpoints(name, monkeypatch):
    monkeypatch.setattr(signatures, "_adder", _shape_only_adder)
    if name in SLIP_CONFIGS:
        cfg = SLIP_CONFIGS[name]
        want = {slip_name(k): v.shape for k, v in signatures.slip_clip_signature(cfg).items()}
        for k in ("visual.class_embedding", "visual.positional_embedding"):  # (1, 1, w), (1, n, w) in the file
            want[k] = want[k][1:] if k == "visual.positional_embedding" else want[k][2:]
    else:
        cfg = CLIP_CONFIGS[name]
        want = {k: v.shape for k, v in signatures.openai_clip_signature(cfg).items()}
    with torch.device("meta"):
        model = CLIP(cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(s) for k, s in want.items()}


@pytest.fixture
def models_dir(tmp_path, monkeypatch, tiny_towers):
    monkeypatch.setenv("PIXRAY_TPU_MODELS", str(tmp_path))
    monkeypatch.setenv("PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER", "1")
    monkeypatch.chdir(tmp_path)
    for name in ("TinyRN64", "TinyTimm48"):
        monkeypatch.setitem(P._CKPT_ALIASES, name, [name.lower() + ".pt"])
    return tmp_path


def _loaded(name):
    return P.Perceptor(name, "cpu", torch.float32).model.state_dict()


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(v)), k


def _jax_sd(name, seed):
    """A tiny tower's JAX random weights (BatchNorms made non-trivial) as an
    OpenAI-layout float32 state dict."""
    jp = JPerceptor(name, dtype=jnp.float32)
    return state_dict_from_flax(randomize_batch_norms(jp.variables, seed), jp.config), jp.config


class _Holder(nn.Module):
    pass


def _torchscript_archive(sd, path):
    """A TorchScript archive whose state dict is ``sd`` (as OpenAI's
    ``.pt`` files are; the archive holds no code the loader runs)."""
    root = _Holder()
    for key, value in sd.items():
        *parents, leaf = key.split(".")
        mod = root
        for part in parents:
            if not hasattr(mod, part):
                mod.add_module(part, _Holder())
            mod = getattr(mod, part)
        mod.register_buffer(leaf, value)
    torch.jit.script(root).save(str(path))


def test_openai_torchscript_archive_fp16(models_dir, capsys):
    sd, cfg = _jax_sd("TinyTest", 0)
    half = {k: torch.tensor(v).half() for k, v in sd.items()}
    extras = {"input_resolution": torch.tensor(32), "context_length": torch.tensor(77),
              "vocab_size": torch.tensor(49408), "logit_scale": torch.tensor(4.6)}
    _torchscript_archive({**half, **extras}, models_dir / "tinytest.pt")
    want = convert_openai_clip({k: v.float().numpy() for k, v in {**half, **extras}.items()}, cfg)
    _assert_state_equal(_loaded("TinyTest"), state_dict_from_flax(want, cfg))
    assert "Loaded perceptor TinyTest from" in capsys.readouterr().out


def test_openai_resnet_state_dict(models_dir):
    sd, cfg = _jax_sd("TinyRN64", 1)
    file_sd = {k: torch.tensor(v) for k, v in sd.items()}
    file_sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
                    for k in sd if k.endswith("running_var")})
    torch.save(file_sd, models_dir / "tinyrn64.pt")
    want = convert_openai_clip({k: v.numpy() for k, v in file_sd.items()}, cfg)
    _assert_state_equal(_loaded("TinyRN64"), state_dict_from_flax(want, cfg))


def test_huggingface_clip(models_dir):
    sd, cfg = _jax_sd("TinyTest", 2)
    hf = {"logit_scale": np.float32(4.6), "text_model.embeddings.position_ids": np.arange(77)[None]}

    def ln(src, dst):
        hf[f"{dst}.weight"], hf[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    def layers(src, dst, n):
        for i in range(n):
            s, d = f"{src}.resblocks.{i}", f"{dst}.layers.{i}"
            ln(f"{s}.ln_1", f"{d}.layer_norm1")
            ln(f"{s}.ln_2", f"{d}.layer_norm2")
            for part in ("weight", "bias"):
                for x, chunk in zip("qkv", np.split(sd[f"{s}.attn.in_proj_{part}"], 3)):
                    hf[f"{d}.self_attn.{x}_proj.{part}"] = chunk
                hf[f"{d}.self_attn.out_proj.{part}"] = sd[f"{s}.attn.out_proj.{part}"]
                hf[f"{d}.mlp.fc1.{part}"] = sd[f"{s}.mlp.c_fc.{part}"]
                hf[f"{d}.mlp.fc2.{part}"] = sd[f"{s}.mlp.c_proj.{part}"]

    emb = "vision_model.embeddings"
    hf[f"{emb}.patch_embedding.weight"] = sd["visual.conv1.weight"]
    hf[f"{emb}.class_embedding"] = sd["visual.class_embedding"]
    hf[f"{emb}.position_embedding.weight"] = sd["visual.positional_embedding"]
    ln("visual.ln_pre", "vision_model.pre_layrnorm")
    ln("visual.ln_post", "vision_model.post_layernorm")
    hf["visual_projection.weight"] = sd["visual.proj"].T
    layers("visual.transformer", "vision_model.encoder", cfg.vision_layers)
    hf["text_model.embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    hf["text_model.embeddings.position_embedding.weight"] = sd["positional_embedding"]
    ln("ln_final", "text_model.final_layer_norm")
    hf["text_projection.weight"] = sd["text_projection"].T
    layers("transformer", "text_model.encoder", cfg.text_layers)
    torch.save({k: torch.tensor(np.ascontiguousarray(v)) for k, v in hf.items()}, models_dir / "tinytest.pt")
    want = convert_hf_clip(hf, cfg)
    _assert_state_equal(_loaded("TinyTest"), state_dict_from_flax(want, cfg))


def test_slip_ddp_file(models_dir):
    sd, cfg = _jax_sd("TinyTimm48", 3)
    slip = {k: sd[slip_name(k)] for k in signatures.slip_clip_signature(cfg)}
    slip["visual.cls_token"] = slip["visual.cls_token"].reshape(1, 1, -1)
    slip["visual.pos_embed"] = slip["visual.pos_embed"][None]
    heads = {"logit_scale": np.float32(2.0), "image_mlp.layer1.weight": np.ones((8, 64), np.float32)}
    torch.save({"epoch": 99, "args": argparse.Namespace(model="SLIP_VITB16"),
                "state_dict": {f"module.{k}": torch.tensor(v) for k, v in {**slip, **heads}.items()}},
               models_dir / "tinytimm48.pt")
    want = convert_slip_clip(slip, cfg)
    _assert_state_equal(_loaded("TinyTimm48"), state_dict_from_flax(want, cfg))


def test_no_file_gives_seeded_random_weights(models_dir, capsys):
    a = _loaded("TinyRN64")
    assert "WARNING: no checkpoint found for perceptor TinyRN64" in capsys.readouterr().out
    _assert_state_equal(_loaded("TinyRN64"), a)


def test_real_weights_need_the_bpe_vocab(models_dir, monkeypatch):
    from pixray_tpu_torch.models.clip.tokenizer import get_tokenizer

    sd, _ = _jax_sd("TinyTest", 4)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, models_dir / "tinytest.pt")
    monkeypatch.delenv("PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER")
    monkeypatch.setattr(get_tokenizer(), "degraded", True)
    with pytest.raises(RuntimeError, match="BPE vocab"):
        P.Perceptor("TinyTest", "cpu")


@pytest.mark.parametrize("perceptors", list(J_PRESETS))
@pytest.mark.parametrize("quality", list(J_PRESETS["clip"]))
def test_quality_presets_resolve_like_jax(quality, perceptors):
    cfg = dict(drawer="pixel", prompts="x", quality=quality, perceptors=perceptors)
    port = apply_settings(dict(cfg), apply_side_effects=False).clip_models
    assert port == j_apply_settings(dict(cfg), apply_side_effects=False).clip_models
    assert all(name in CLIP_CONFIGS or name in SLIP_CONFIGS for name in port)
