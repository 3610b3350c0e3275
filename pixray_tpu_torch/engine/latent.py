"""Latents as one tensor or a dict of tensors (the JAX package's pytrees).

Dict leaves are visited in sorted key order, as ``jax.tree_util`` and
``ravel_pytree`` visit them, so :func:`ravel` gives the JAX package's flat
vector (clipdraw: colors, points, widths).
"""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf over trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


def leaves(tree) -> list:
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def unflatten(tree, values: list):
    """A tree of ``tree``'s structure holding ``values`` (in :func:`leaves` order)."""
    return dict(zip(sorted(tree), values)) if isinstance(tree, dict) else values[0]


def ravel(tree) -> torch.Tensor:
    """All leaves flattened and concatenated (``jax.flatten_util.ravel_pytree``)."""
    return torch.cat([leaf.reshape(-1) for leaf in leaves(tree)])
