"""Filter plug-in contract (port of ``pixray_tpu/filters/base.py``).

A filter maps the synthesized (H, W, C) canvas inside the step and may
emit a loss: ``filter(img, draws) -> (img, loss)``.  Its random numbers
come in ``draws``, a (2,) integer tensor on the step's device that the
host drew with :meth:`FilterInterface.draw` (the JAX package draws
``randint(kh, (), 0, h)`` and ``randint(kw, (), 0, w)`` from the filter's
key), so a captured CUDA graph reads each step's draws from the block's
inputs.  ``out_shape`` says statically what shape a filter leaves, since
the next filter's draws depend on it.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.losses.base import DeviceConstants


def roll(img, shift, dim: int):
    """``jnp.roll(img, shift, dim)`` by a device shift: out[i] = in[(i - shift) mod n]."""
    n = img.shape[dim]
    idx = torch.remainder(torch.arange(n, dtype=shift.dtype, device=img.device) - shift, n)
    return img.index_select(dim, idx)


class FilterInterface(DeviceConstants):
    @staticmethod
    def add_settings(parser):
        return parser

    def __init__(self, settings=None):
        self.settings = settings

    def out_shape(self, h: int, w: int):
        return h, w

    def draw(self, gen, h: int, w: int):
        """The filter's draws for an (h, w) input: (rand_h, rand_w)."""
        return 0, 0

    def __call__(self, img, draws):
        return img, img.new_zeros(())


def draw_shifts(gen, h: int, w: int):
    """(rand_h in [0, h), rand_w in [0, w)) from the host generator."""
    return int(torch.randint(0, h, (), generator=gen)), int(torch.randint(0, w, (), generator=gen))
