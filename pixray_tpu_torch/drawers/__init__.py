"""Drawer registry of the port: ``pixel``, ``fast_pixel``, ``fft``, ``clipdraw``,
``line_sketch`` and ``vqgan`` so far (``vdiff`` and ``super_resolution`` raise)."""

from __future__ import annotations

import importlib

_DRAWER_MODULES = {
    "fast_pixel": ("pixray_tpu_torch.drawers.fast_pixel", "FastPixelDrawer"),
    "pixel": ("pixray_tpu_torch.drawers.pixel", "PixelDrawer"),
    "fft": ("pixray_tpu_torch.drawers.fft", "FftDrawer"),
    "clipdraw": ("pixray_tpu_torch.drawers.clipdraw", "ClipDrawer"),
    "line_sketch": ("pixray_tpu_torch.drawers.line_sketch", "LineDrawer"),
    "vqgan": ("pixray_tpu_torch.drawers.vqgan", "VqganDrawer"),
}


def drawer_class(name: str) -> type:
    if name not in _DRAWER_MODULES:
        raise NotImplementedError(
            f"drawer {name!r} is not yet ported to pixray_tpu_torch "
            f"(ported: {sorted(_DRAWER_MODULES)})"
        )
    module_name, class_name = _DRAWER_MODULES[name]
    return getattr(importlib.import_module(module_name), class_name)
