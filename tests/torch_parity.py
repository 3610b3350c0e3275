"""What the port's parity tests share: the JAX package's perceptor cache
kept apart per test, and torch's thread count in a pytest-xdist worker.

``pixray_tpu.models.perceptor.get_clip_perceptor`` caches a tower by its
name alone and ignores the ``dtype`` of a later call.  A JAX-package test
that builds ``TinyTest`` at the default bfloat16 would hand a parity test
in the same process (the JAX Engine at ``precision="fp32"``) its bf16
tower, and leave the parity test's f32 tower to the next JAX test.  A test
module that builds a JAX Engine imports :func:`jax_perceptor_cache` and
marks its tests with it::

    from torch_parity import jax_perceptor_cache  # noqa: F401

    pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")

Under pytest-xdist every worker imports every test module, and with it
this one: each worker then runs torch's CPU ops on its share of the cores
(``WORKER_THREADS``).  With the default, six workers on eight cores ran
48 OpenMP threads, and a heavy test took 5-20 times as long as alone (the
threads spin at each parallel region's barrier while the one with the
work waits for a core).  A run in one process keeps every core.
"""

import os

import pytest
import torch

from pixray_tpu.models import perceptor as j_perceptor

WORKER_THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(WORKER_THREADS)


@pytest.fixture
def jax_perceptor_cache(monkeypatch):
    """A fresh, empty JAX perceptor cache for the test; the process's own cache comes back after it."""
    cache = {}
    monkeypatch.setattr(j_perceptor, "_perceptor_cache", cache)
    return cache


# Tiny towers of the two new kinds, put into both packages' config tables
# for a test module by ``tiny_towers``: a ModifiedResNet at 32 px (1x1
# after the stem and stages) and at 64 px with two blocks in one stage (2x2,
# so the attention pool's token order matters), and a timm (SLIP-style)
# trunk at 48 px.  The port's own tables gain no name the JAX package lacks.
TINY_RN = dict(name="TinyRN", embed_dim=32, image_resolution=32, vision_kind="resnet", vision_width=8,
               vision_layers=(1, 1, 1, 1), vision_patch_size=None, vision_heads=4, context_length=77,
               vocab_size=49408, text_width=64, text_heads=2, text_layers=2)
TINY_CLIP = {"TinyRN": TINY_RN,
             "TinyRN64": dict(TINY_RN, name="TinyRN64", image_resolution=64, vision_layers=(1, 2, 1, 1))}
TINY_SLIP = {"TinyTimm48": dict(name="TinyTimm48", embed_dim=32, image_resolution=48, vision_kind="vit",
                                vision_width=64, vision_layers=2, vision_patch_size=16, vision_heads=2,
                                context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2,
                                vision_style="timm")}


def register_tiny_towers(mp):
    from pixray_tpu.models.clip import configs as jcfg
    from pixray_tpu_torch.models.clip import configs as pcfg

    for key, towers in (("CLIP_CONFIGS", TINY_CLIP), ("SLIP_CONFIGS", TINY_SLIP)):
        for name, fields in towers.items():
            mp.setitem(getattr(jcfg, key), name, jcfg.CLIPConfig(**fields))
            mp.setitem(getattr(pcfg, key), name, pcfg.CLIPConfig(**fields))


@pytest.fixture(scope="module")
def tiny_towers():
    with pytest.MonkeyPatch.context() as mp:
        register_tiny_towers(mp)
        yield


def randomize_batch_norms(variables, seed):
    """numpy copies of flax variables with every BatchNorm made non-trivial:
    scale in [0.5, 1.5], bias and running mean normal(0, 0.3), running
    variance in [0.5, 2]."""
    import jax
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.array(leaf, dtype=np.float32)
        names = [getattr(p, "key", "") for p in path]
        if not any(n.startswith(("bn", "downsample_bn")) for n in names):
            return leaf
        return {"scale": lambda s: rng.uniform(0.5, 1.5, s), "var": lambda s: rng.uniform(0.5, 2.0, s)}.get(
            names[-1], lambda s: rng.normal(0.0, 0.3, s))(leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(variables))
