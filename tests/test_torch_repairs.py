"""Two faults of the port, held repaired on the CPU.

- A bf16 tower keeps its LayerNorm affines in float32, as the JAX
  ``Perceptor._cast_storage`` keeps every ``ln_*`` / ``norm*`` leaf: a
  ViT (``TinyTest``) and a timm trunk (``TinyTimm48``, ``tests/torch_parity.py``)
  whose LayerNorm weights and biases the test writes (drawn in float32,
  not ones and zeros, and not bf16 values), against the JAX ``Perceptor``
  under both ``PIXRAY_TPU_CLIP_LN32`` values: the affines are float32
  tensors equal to the written ones bitwise, and the image and text
  embeddings agree within ``EMBED_ATOL`` (both towers compute in bf16 and
  round some sums elsewhere, as in ``tests/test_torch_tower_rungs.py``).
  Both branches of the port's ``LayerNorm`` take a bf16 input with float32
  affines and return bf16, without handing ``F.layer_norm`` the mixed
  dtypes the card's refuses.
- The process group's backend follows the device: ``init_distributed``
  with a CPU device picks gloo even where the host has a card for every
  local rank (the card count stubbed), ``Engine._build_mesh`` passes the
  engine's device to it, and the dry run's CPU ranks join gloo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.models import perceptor as JP
from pixray_tpu_torch.config.precision import Rungs
from pixray_tpu_torch.models import perceptor as PP
from pixray_tpu_torch.models.clip import model as PM
from pixray_tpu_torch.models.clip.bridge import state_dict_from_flax
from pixray_tpu_torch.parallel import dryrun
from pixray_tpu_torch.parallel import mesh as M
from torch_parity import jax_perceptor_cache, tiny_towers  # noqa: F401

EMBED_ATOL = 1.5e-2


def _written_norms(params, seed):
    """numpy copies of flax params with every LayerNorm's scale drawn in
    [0.5, 1.5] and bias from normal(0, 0.3), in float32."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.array(leaf, dtype=np.float32)
        names = [getattr(p, "key", "") for p in path]
        if not any(n.startswith(("ln_", "norm")) for n in names):
            return leaf
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.3, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(params))


@pytest.mark.usefixtures("jax_perceptor_cache", "tiny_towers")
@pytest.mark.parametrize("name", ["TinyTest", "TinyTimm48"])
@pytest.mark.parametrize("ln32", ["1", "0"])
def test_bf16_tower_keeps_layernorm_affines_f32(name, ln32, monkeypatch):
    monkeypatch.setenv("PIXRAY_TPU_CLIP_PREC", "bf16")
    monkeypatch.setenv("PIXRAY_TPU_CLIP_LN32", ln32)
    jp = JP.Perceptor(name, dtype=jnp.bfloat16)
    loaded = jp._load_variables(name)
    params = _written_norms(loaded["params"], seed=len(name) + int(ln32))
    jp.variables = jp._cast_storage({**loaded, "params": jax.tree_util.tree_map(jnp.asarray, params)},
                                    jnp.bfloat16)
    sd = state_dict_from_flax(params, jp.config)
    pp = PP.Perceptor(name, "cpu", torch.bfloat16, sd, rungs=Rungs(clip="bf16", clip_ln32=ln32 != "0"))

    norms = [(n, m) for n, m in pp.model.named_modules() if isinstance(m, PM.LayerNorm)]
    assert norms and all(m.ln32 == (ln32 != "0") for _, m in norms)
    assert all(m.weight.dtype == torch.float32 and m.bias.dtype == torch.float32 for _, m in norms)
    for n, m in norms:
        np.testing.assert_array_equal(m.weight.numpy(), np.asarray(sd[f"{n}.weight"]), err_msg=n)
        np.testing.assert_array_equal(m.bias.numpy(), np.asarray(sd[f"{n}.bias"]), err_msg=n)
    assert pp.model.visual.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.bfloat16

    r = jp.input_resolution
    imgs = np.random.default_rng(0).random((4, 3, r, r)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jp.image_fn(jp.variables, x, data_format="NCHW"),
                             compiler_options={"xla_allow_excess_precision": False})(jnp.asarray(imgs)))
    with torch.no_grad():
        emb = pp.image_fn(torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(emb, ref, rtol=0, atol=EMBED_ATOL)
    text = ["a red circle", "sunrise over the sea"]
    np.testing.assert_allclose(pp.encode_text(text).numpy(), np.asarray(jp.encode_text(text)), rtol=0,
                               atol=EMBED_ATOL * float(np.abs(np.asarray(jp.encode_text(text))).max()))


@pytest.mark.parametrize("written", [True, False])
@pytest.mark.parametrize("ln32", [True, False])
def test_layernorm_takes_bf16_input_with_f32_affines(ln32, written, monkeypatch):
    """Both branches, with ``F.layer_norm`` as strict as on the card, where
    it takes no bf16 input with float32 affines (the CPU's accepts them):
    affines written in float32 and the ones and zeros a tower starts with
    both give the float32 LayerNorm, with no state beside the affine."""
    layer_norm = torch.nn.functional.layer_norm

    def strict(x, shape, weight=None, bias=None, eps=1e-5):
        assert weight is None or weight.dtype == x.dtype, (x.dtype, weight.dtype)
        return layer_norm(x, shape, weight, bias, eps)

    monkeypatch.setattr(torch.nn.functional, "layer_norm", strict)
    torch.manual_seed(0)
    ln = PM.LayerNorm(24)
    ln.ln32 = ln32
    if written:
        with torch.no_grad():
            ln.weight.uniform_(0.5, 1.5)
            ln.bias.normal_(0.0, 0.3)
    assert sorted(ln.state_dict()) == ["bias", "weight"] and not list(ln.buffers())
    x = torch.randn((5, 24)).to(torch.bfloat16)
    with torch.no_grad():
        y = ln(x)
    assert ln.weight.dtype == torch.float32 and y.dtype == torch.bfloat16
    ref = layer_norm(x.float(), (24,), ln.weight, ln.bias, ln.eps).detach()
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=0, atol=3e-2)


class _Joined(Exception):
    """Raised by the stubbed init_process_group, with the backend it was given."""


def _stub_group(monkeypatch, cards):
    def init_process_group(backend, **kwargs):
        raise _Joined(backend)

    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(M.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(M.torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(M.torch.cuda, "set_device", lambda i: None)


@pytest.mark.parametrize("device,want", [("cpu", "gloo"), (torch.device("cpu"), "gloo"), ("cuda", "nccl"),
                                         (None, "nccl")])
def test_init_distributed_backend_follows_the_device(device, want, monkeypatch):
    """Two local ranks, two cards: nccl for a card or no device, gloo for the CPU."""
    _stub_group(monkeypatch, cards=2)
    with pytest.raises(_Joined) as joined:
        M.init_distributed("localhost:29500", 2, 0, device=device)
    assert str(joined.value) == want


def test_engine_mesh_passes_its_device(monkeypatch):
    """Engine._build_mesh joins the group for the engine's device: gloo on
    the CPU, whatever the host's card count."""
    from pixray_tpu_torch.engine.core import Engine

    _stub_group(monkeypatch, cards=4)
    for key in ("PIXRAY_TPU_COORDINATOR", "PIXRAY_TPU_NUM_PROCESSES", "PIXRAY_TPU_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PIXRAY_TPU_COORDINATOR", "127.0.0.1:29501")
    monkeypatch.setenv("PIXRAY_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("PIXRAY_TPU_PROCESS_ID", "1")
    args = dryrun.tiny_settings(shard_cutouts=True)
    with pytest.raises(_Joined) as joined:
        Engine._build_mesh(args, "cpu")
    assert str(joined.value) == "gloo"


def test_dryrun_cpu_ranks_join_gloo(monkeypatch):
    """``python -m pixray_tpu_torch.parallel.dryrun N --device cpu`` spawns
    its ranks with gloo; on the card it leaves the choice to the card count."""
    calls = []
    monkeypatch.setattr(dryrun, "launch", lambda fn, n, **kw: calls.append(kw) or [[]])
    dryrun.main(["2", "--device", "cpu"])
    dryrun.main(["2", "--device", "cuda"])
    assert [c["backend"] for c in calls] == ["gloo", None]
    assert [c["device"] for c in calls] == ["cpu", "cuda"]
