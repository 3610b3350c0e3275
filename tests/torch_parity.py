"""What the port's parity tests share: the JAX package's perceptor cache
kept apart per test.

``pixray_tpu.models.perceptor.get_clip_perceptor`` caches a tower by its
name alone and ignores the ``dtype`` of a later call.  A JAX-package test
that builds ``TinyTest`` at the default bfloat16 would hand a parity test
in the same process (the JAX Engine at ``precision="fp32"``) its bf16
tower, and leave the parity test's f32 tower to the next JAX test.  A test
module that builds a JAX Engine imports :func:`jax_perceptor_cache` and
marks its tests with it::

    from torch_parity import jax_perceptor_cache  # noqa: F401

    pytestmark = pytest.mark.usefixtures("jax_perceptor_cache")
"""

import pytest

from pixray_tpu.models import perceptor as j_perceptor


@pytest.fixture
def jax_perceptor_cache(monkeypatch):
    """A fresh, empty JAX perceptor cache for the test; the process's own cache comes back after it."""
    cache = {}
    monkeypatch.setattr(j_perceptor, "_perceptor_cache", cache)
    return cache
