"""Adam as optax computes it (port of the ``Adam`` entry of ``pixray_tpu/engine/optimizers.py``).

optax.adam: mu ← b1·mu + (1-b1)·g, nu ← b2·nu + (1-b2)·g², bias
corrections by 1-b^count, update = -lr · mu_hat / (sqrt(nu_hat) + eps).
Parameters are a tensor or a dict of tensors (``engine/latent.py``).  The
learning rate is state (``set_learning_rate``), like optax's
``inject_hyperparams``.  :class:`PerGroupAdam` is the drawers' per-group
optimizer (``optax.multi_transform`` with one ``optax.adam`` per dict key).
Other optimizers are not ported yet.

The whole state lives on the parameters' device (the count an int32
tensor, as optax's is) and ``update`` and ``reset`` change it in place:
a captured CUDA graph of the step reads and writes it at fixed addresses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from pixray_tpu_torch.engine.latent import leaves, tree_map


@dataclass
class AdamState:
    count: torch.Tensor  # () int32
    mu: Any
    nu: Any
    learning_rate: torch.Tensor  # () float32


class Adam:
    def __init__(self, learning_rate: float, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        dev = leaves(params)[0].device
        zeros = lambda: tree_map(torch.zeros_like, params)
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros(),
                         torch.full((), self.learning_rate, dtype=torch.float32, device=dev))

    def update(self, grads, state: AdamState):
        """Returns (updates, state); ``state`` is updated in place.  Apply with ``params + updates``."""
        state.count.add_(1)
        count = state.count.float()
        c1 = 1 - torch.pow(self.b1, count)
        c2 = 1 - torch.pow(self.b2, count)
        for m, v, g in zip(leaves(state.mu), leaves(state.nu), leaves(grads)):
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))

        def step(m, v):
            return -state.learning_rate * ((m / c1) / (torch.sqrt(v / c2) + self.eps))

        return tree_map(step, state.mu, state.nu), state

    def reset(self, state: AdamState) -> None:
        """A fresh state in place (the engine's LR drop)."""
        state.count.zero_()
        for t in leaves(state.mu) + leaves(state.nu):
            t.zero_()

    @staticmethod
    def clone(state: AdamState) -> AdamState:
        copy = lambda t: t.clone()
        return AdamState(state.count.clone(), tree_map(copy, state.mu), tree_map(copy, state.nu),
                         state.learning_rate.clone())


class PerGroupAdam:
    """One Adam per key of a dict latent, each with its own learning rate."""

    def __init__(self, learning_rates: dict):
        self.groups = {k: Adam(lr) for k, lr in learning_rates.items()}

    def init(self, params: dict) -> dict:
        if set(params) != set(self.groups):
            raise ValueError(f"latent keys {sorted(params)} are not the groups {sorted(self.groups)}")
        return {k: opt.init(params[k]) for k, opt in self.groups.items()}

    def update(self, grads: dict, state: dict):
        out = {k: opt.update(grads[k], state[k]) for k, opt in self.groups.items()}
        return {k: u for k, (u, _) in out.items()}, state

    def reset(self, state: dict) -> None:
        for k, opt in self.groups.items():
            opt.reset(state[k])

    @staticmethod
    def clone(state: dict) -> dict:
        return {k: Adam.clone(s) for k, s in state.items()}


def state_tensors(state) -> list:
    """Every tensor of an optimizer state (Adam's or per-group), in a fixed order."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in state_tensors(state[k])]
    return [state.count, *leaves(state.mu), *leaves(state.nu), state.learning_rate]


def build_optimizer(name: str, learning_rate: float) -> Adam:
    if name != "Adam":
        raise NotImplementedError(f"optimiser {name!r} is not yet ported to pixray_tpu_torch (Adam only)")
    return Adam(learning_rate)


def set_learning_rate(opt_state: AdamState, learning_rate: float) -> AdamState:
    opt_state.learning_rate.fill_(learning_rate)
    return opt_state
