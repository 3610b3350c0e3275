"""Adam as optax computes it (port of the ``Adam`` entry of ``pixray_tpu/engine/optimizers.py``).

optax.adam: mu ← b1·mu + (1-b1)·g, nu ← b2·nu + (1-b2)·g², bias
corrections by 1-b^count, update = -lr · mu_hat / (sqrt(nu_hat) + eps).
The learning rate is state (``set_learning_rate``), like optax's
``inject_hyperparams``.  Other optimizers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class AdamState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    learning_rate: float


class Adam:
    def __init__(self, learning_rate: float, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params), self.learning_rate)

    def update(self, grads, state: AdamState):
        """Returns (updates, new state); apply with ``params + updates``."""
        count = state.count + 1
        mu = self.b1 * state.mu + (1 - self.b1) * grads
        nu = self.b2 * state.nu + (1 - self.b2) * torch.square(grads)
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        mu_hat = mu / c1.to(mu.device)
        nu_hat = nu / c2.to(nu.device)
        updates = -state.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, AdamState(count, mu, nu, state.learning_rate)


def build_optimizer(name: str, learning_rate: float) -> Adam:
    if name != "Adam":
        raise NotImplementedError(f"optimiser {name!r} is not yet ported to pixray_tpu_torch (Adam only)")
    return Adam(learning_rate)


def set_learning_rate(opt_state: AdamState, learning_rate: float) -> AdamState:
    opt_state.learning_rate = float(learning_rate)
    return opt_state
