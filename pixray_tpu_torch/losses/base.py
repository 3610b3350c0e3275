"""Loss plug-in contract (port of ``pixray_tpu/losses/base.py``).

``get_loss(cur_cutouts, out, args, globals=None, lossGlobals=None)`` runs
inside the step, and on the card inside a captured CUDA graph: it reads
only tensors.  ``cur_cutouts`` is {cut_size: (N, S, S, 3) float32
cutouts}, ``out`` the (H, W, 3) canvas after the filters, ``globals``
{"cur_iteration", "fill_color": () device tensors, "embeds": the last
perceptor's (N, D) embeddings}, ``lossGlobals`` what the losses'
``add_globals`` returned.  Host set-up (files, weights) happens in
``__init__``; a constant reaches the device once, through
:meth:`DeviceConstants.constant`, at the first (eager) step.
"""

from __future__ import annotations

import argparse


class DeviceConstants:
    """Constants made on the host and moved to a device once per key."""

    def constant(self, key, device, make):
        """``make()`` (a host tensor) on ``device``, cached under (``key``, device)."""
        cache = self.__dict__.setdefault("_device_constants", {})
        full = (key, str(device))
        if full not in cache:
            cache[full] = make().to(device)
        return cache[full]


class LossInterface(DeviceConstants):
    def __init__(self, settings=None):
        self.settings = settings

    def instance_settings(self, arglist):
        """Optional per-instance string args from 'loss->arg1->arg2' specs."""

    @staticmethod
    def add_settings(parser):
        return parser

    def help(self):
        parser = argparse.ArgumentParser()
        parser = self.add_settings(parser)
        return "\n".join(
            f"parameter name: {d.dest}\nHelp: {d.help}" for d in parser._actions
        )

    def add_globals(self, args) -> dict:
        return {}

    def get_loss(self, cur_cutouts, out, args, globals=None, lossGlobals=None):
        raise NotImplementedError
