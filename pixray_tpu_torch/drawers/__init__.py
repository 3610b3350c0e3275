"""Drawer registry of the port: every drawer of the JAX package (``pixel``,
``fast_pixel``, ``fft``, ``clipdraw``, ``line_sketch``, ``vqgan``, ``vdiff``,
``super_resolution``); another name raises."""

from __future__ import annotations

import importlib

_DRAWER_MODULES = {
    "fast_pixel": ("pixray_tpu_torch.drawers.fast_pixel", "FastPixelDrawer"),
    "pixel": ("pixray_tpu_torch.drawers.pixel", "PixelDrawer"),
    "fft": ("pixray_tpu_torch.drawers.fft", "FftDrawer"),
    "clipdraw": ("pixray_tpu_torch.drawers.clipdraw", "ClipDrawer"),
    "line_sketch": ("pixray_tpu_torch.drawers.line_sketch", "LineDrawer"),
    "vqgan": ("pixray_tpu_torch.drawers.vqgan", "VqganDrawer"),
    "vdiff": ("pixray_tpu_torch.drawers.vdiff", "VdiffDrawer"),
    "super_resolution": ("pixray_tpu_torch.drawers.super_resolution", "SuperResolutionDrawer"),
}


def drawer_class(name: str) -> type:
    if name not in _DRAWER_MODULES:
        raise NotImplementedError(
            f"drawer {name!r} is not yet ported to pixray_tpu_torch "
            f"(ported: {sorted(_DRAWER_MODULES)})"
        )
    module_name, class_name = _DRAWER_MODULES[name]
    return getattr(importlib.import_module(module_name), class_name)
