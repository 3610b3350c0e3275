"""Adam as optax computes it (port of the ``Adam`` entry of ``pixray_tpu/engine/optimizers.py``).

optax.adam: mu ← b1·mu + (1-b1)·g, nu ← b2·nu + (1-b2)·g², bias
corrections by 1-b^count, update = -lr · mu_hat / (sqrt(nu_hat) + eps).
Parameters are a tensor or a dict of tensors (``engine/latent.py``).  The
learning rate is state (``set_learning_rate``), like optax's
``inject_hyperparams``.  :class:`PerGroupAdam` is the drawers' per-group
optimizer (``optax.multi_transform`` with one ``optax.adam`` per dict key).
Other optimizers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from pixray_tpu_torch.engine.latent import tree_map


@dataclass
class AdamState:
    count: int
    mu: Any
    nu: Any
    learning_rate: float


class Adam:
    def __init__(self, learning_rate: float, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        zeros = lambda: tree_map(torch.zeros_like, params)
        return AdamState(0, zeros(), zeros(), self.learning_rate)

    def update(self, grads, state: AdamState):
        """Returns (updates, new state); apply with ``params + updates``."""
        count = state.count + 1
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * torch.square(g), state.nu, grads)
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count

        def step(m, v):
            mu_hat = m / c1.to(m.device)
            nu_hat = v / c2.to(v.device)
            return -state.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + self.eps))

        return tree_map(step, mu, nu), AdamState(count, mu, nu, state.learning_rate)


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
        return {k: u for k, (u, _) in out.items()}, {k: s for k, (_, s) in out.items()}


def build_optimizer(name: str, learning_rate: float) -> Adam:
    if name != "Adam":
        raise NotImplementedError(f"optimiser {name!r} is not yet ported to pixray_tpu_torch (Adam only)")
    return Adam(learning_rate)


def set_learning_rate(opt_state: AdamState, learning_rate: float) -> AdamState:
    opt_state.learning_rate = float(learning_rate)
    return opt_state
