"""Drawer registry of the port: ``pixel``, ``clipdraw`` and ``line_sketch`` so far."""

from __future__ import annotations

import importlib

_DRAWER_MODULES = {
    "pixel": ("pixray_tpu_torch.drawers.pixel", "PixelDrawer"),
    "clipdraw": ("pixray_tpu_torch.drawers.clipdraw", "ClipDrawer"),
    "line_sketch": ("pixray_tpu_torch.drawers.line_sketch", "LineDrawer"),
}


def drawer_class(name: str) -> type:
    if name not in _DRAWER_MODULES:
        raise NotImplementedError(
            f"drawer {name!r} is not yet ported to pixray_tpu_torch "
            f"(ported: {sorted(_DRAWER_MODULES)})"
        )
    module_name, class_name = _DRAWER_MODULES[name]
    return getattr(importlib.import_module(module_name), class_name)
