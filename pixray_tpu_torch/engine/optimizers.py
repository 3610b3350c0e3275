"""The optimizer suite as optax computes it (port of ``pixray_tpu/engine/optimizers.py``).

The JAX package wraps each optimizer in ``optax.inject_hyperparams``; each
class here computes what its optax counterpart (optax 0.2.6) computes, not
what ``torch.optim`` would:

- ``Adam``: optax.adam.  mu ← b1·mu + (1-b1)·g, nu ← b2·nu + (1-b2)·g²,
  bias corrections by 1-b^count, update = -lr · mu_hat / (sqrt(nu_hat) + eps).
- ``AdamW``: optax.adamw: the Adam direction plus weight decay 1e-4 (torch's
  default is 1e-2), update = -lr · (direction + 1e-4 · p).
- ``Adagrad``: optax.adagrad: the accumulator starts at 0.1 (torch's at 0),
  acc ← acc + g², update = -lr · where(acc > 0, rsqrt(acc + 1e-7), 0) · g.
- ``Adamax``: nu ← max(b2·nu, |g| + eps), no bias correction of nu,
  update = -lr · mu_hat / nu.
- ``DiffGrad``: the Adam direction times sigmoid(|g_prev - g|); the
  previous gradient is state.
- ``AdamP``: the Adam direction with its radial component projected out
  where |cos(p, direction)| < 0.1 / sqrt(p.numel()) (a ``torch.where`` on
  the device; parameters of no dimension keep the direction).

Parameters are a tensor or a dict of tensors (``engine/latent.py``).  The
learning rate is state (``set_learning_rate``), like optax's
``inject_hyperparams``.  :class:`PerGroupAdam` is the stroke drawers'
per-group optimizer (``optax.multi_transform`` with one ``optax.adam`` per
dict key).

The whole state lives on the parameters' device (the count an int32
tensor, as optax's is) and ``update`` and ``reset`` change it in place:
a captured CUDA graph of the step reads and writes it at fixed addresses,
so one captured block serves every optimizer.  ``reset`` gives exactly
``init``'s state (the engine's LR drop).  ``jax_leaves`` lists the state's
tensors in the order of the JAX package's optax state leaves, for the
session checkpoints (``engine/checkpoint.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any

import torch

from pixray_tpu_torch.engine.latent import leaves, tree_map


@dataclass
class AdamState:
    count: torch.Tensor  # () int32
    mu: Any
    nu: Any
    learning_rate: torch.Tensor  # () float32


@dataclass
class DiffGradState(AdamState):
    prev_grad: Any = None


@dataclass
class AdagradState:
    count: torch.Tensor  # () int32: inject_hyperparams' count
    sum_of_squares: Any
    learning_rate: torch.Tensor


def _scalar(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


class Adam:
    state_cls = AdamState
    moments = ("mu", "nu")  # the state's trees, in optax's leaf order
    initial = 0.0  # their value at init
    inner_count = True  # optax's inner state carries a count of its own

    def __init__(self, learning_rate: float, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        dev = leaves(params)[0].device
        trees = {m: tree_map(lambda p: torch.full_like(p, self.initial), params) for m in self.moments}
        return self.state_cls(count=_scalar(0, torch.int32, dev),
                              learning_rate=_scalar(self.learning_rate, torch.float32, dev), **trees)

    def update(self, grads, state, params=None):
        """Returns (updates, state); ``state`` is updated in place.  Apply
        with ``params + updates``.  ``params``: the parameters before the
        update (AdamW's decay and AdamP's projection read them)."""
        return tree_map(lambda d: -state.learning_rate * d, self._direction(grads, state)), state

    def reset(self, state) -> None:
        """``init``'s state, written in place (the engine's LR drop)."""
        state.count.zero_()
        state.learning_rate.fill_(self.learning_rate)
        for m in self.moments:
            for t in leaves(getattr(state, m)):
                t.fill_(self.initial)

    @staticmethod
    def clone(state):
        return type(state)(**{f.name: tree_map(torch.clone, getattr(state, f.name)) for f in fields(state)})

    def jax_leaves(self, state) -> list:
        """The state's tensors in the order of the JAX package's optax leaves:
        inject_hyperparams' count and learning rate, then the inner state
        (its count, where it has one, and each moment's leaves)."""
        inner = [state.count] if self.inner_count else []
        return [state.count, state.learning_rate, *inner, *[t for m in self.moments
                                                            for t in leaves(getattr(state, m))]]

    def _direction(self, grads, state):
        """Advance count, mu and nu in place; the Adam direction mu_hat / (sqrt(nu_hat) + eps)."""
        state.count.add_(1)
        count = state.count.float()
        c1 = 1 - torch.pow(self.b1, count)
        c2 = 1 - torch.pow(self.b2, count)
        for m, v, g in zip(leaves(state.mu), leaves(state.nu), leaves(grads)):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * torch.square(g) + self.b2 * v)
        return tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + self.eps), state.mu, state.nu)


class AdamW(Adam):
    def __init__(self, learning_rate: float, weight_decay=1e-4, **kw):
        super().__init__(learning_rate, **kw)
        self.weight_decay = weight_decay

    def update(self, grads, state, params=None):
        direction = self._direction(grads, state)
        return tree_map(lambda d, p: -state.learning_rate * (d + self.weight_decay * p), direction, params), state


class Adagrad(Adam):
    state_cls = AdagradState
    moments = ("sum_of_squares",)
    initial = 0.1
    inner_count = False

    def __init__(self, learning_rate: float, eps=1e-7):
        self.learning_rate, self.eps = learning_rate, eps

    def update(self, grads, state, params=None):
        state.count.add_(1)
        for acc, g in zip(leaves(state.sum_of_squares), leaves(grads)):
            acc.copy_(torch.square(g) + acc)

        def step(acc, g):
            return -state.learning_rate * (torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0) * g)

        return tree_map(step, state.sum_of_squares, grads), state


class Adamax(Adam):
    def update(self, grads, state, params=None):
        state.count.add_(1)
        c1 = 1 - torch.pow(self.b1, state.count.float())
        for m, v, g in zip(leaves(state.mu), leaves(state.nu), leaves(grads)):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_(torch.maximum(torch.abs(g) + self.eps, self.b2 * v))
        return tree_map(lambda m, v: -state.learning_rate * ((m / c1) / v), state.mu, state.nu), state


class DiffGrad(Adam):
    state_cls = DiffGradState
    moments = ("mu", "nu", "prev_grad")

    def update(self, grads, state, params=None):
        direction = self._direction(grads, state)
        friction = tree_map(lambda g, prev: torch.sigmoid(torch.abs(prev - g)), grads, state.prev_grad)
        updates = tree_map(lambda d, f: -state.learning_rate * (d * f), direction, friction)
        for prev, g in zip(leaves(state.prev_grad), leaves(grads)):
            prev.copy_(g)
        return updates, state


class AdamP(Adam):
    def __init__(self, learning_rate: float, delta=0.1, **kw):
        super().__init__(learning_rate, **kw)
        self.delta = delta

    def _project(self, step, p):
        if p.ndim == 0:
            return step
        p_flat, s_flat = p.reshape(-1), step.reshape(-1)
        p_norm = torch.linalg.vector_norm(p_flat) + self.eps
        cos = torch.abs(torch.dot(p_flat / p_norm, s_flat / (torch.linalg.vector_norm(s_flat) + self.eps)))
        radial = torch.dot(p_flat, s_flat) / p_norm**2
        projected = s_flat - radial * p_flat
        use_proj = cos < self.delta / math.sqrt(p_flat.numel())
        return torch.where(use_proj, projected, s_flat).reshape(step.shape)

    def update(self, grads, state, params=None):
        direction = self._direction(grads, state)
        if params is not None:
            direction = tree_map(self._project, direction, params)
        return tree_map(lambda d: -state.learning_rate * d, direction), state


class PerGroupAdam:
    """One Adam per key of a dict latent, each with its own learning rate."""

    def __init__(self, learning_rates: dict):
        self.groups = {k: Adam(lr) for k, lr in learning_rates.items()}

    def init(self, params: dict) -> dict:
        if set(params) != set(self.groups):
            raise ValueError(f"latent keys {sorted(params)} are not the groups {sorted(self.groups)}")
        return {k: opt.init(params[k]) for k, opt in self.groups.items()}

    def update(self, grads: dict, state: dict, params=None):
        out = {k: opt.update(grads[k], state[k]) for k, opt in self.groups.items()}
        return {k: u for k, (u, _) in out.items()}, state

    def reset(self, state: dict) -> None:
        for k, opt in self.groups.items():
            opt.reset(state[k])

    @staticmethod
    def clone(state: dict) -> dict:
        return {k: Adam.clone(s) for k, s in state.items()}

    def jax_leaves(self, state: dict) -> list:
        """optax.multi_transform's leaves: per group, in sorted order, its
        plain optax.adam state (count, mu, nu; no injected learning rate)."""
        return [t for k in sorted(state) for t in (state[k].count, state[k].mu, state[k].nu)]


def state_tensors(state) -> list:
    """Every tensor of an optimizer state (one optimizer's or per-group), in a fixed order."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in state_tensors(state[k])]
    return [t for f in fields(state) for t in leaves(getattr(state, f.name))]


OPTIMIZERS = {"Adam": Adam, "AdamW": AdamW, "Adagrad": Adagrad, "Adamax": Adamax, "DiffGrad": DiffGrad,
              "AdamP": AdamP}


def build_optimizer(name: str, learning_rate: float):
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimiser: {name}")
    return OPTIMIZERS[name](learning_rate)


def set_learning_rate(opt_state, learning_rate: float):
    opt_state.learning_rate.fill_(learning_rate)
    return opt_state
