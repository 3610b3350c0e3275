"""The check that no JAX and nothing of the JAX package is loaded: each
module's top-level name (the part before the first dot), compared whole."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "pixray_tpu"})


def loaded(modules=None) -> list[str]:
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
