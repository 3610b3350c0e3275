"""Filter registry of the port (``pixray_tpu/registry.py``'s filter table)."""

from __future__ import annotations

import importlib

_FILTER_MODULES = {
    "lookup": ("pixray_tpu_torch.filters.lookup", "ColorLookup"),
    "tiler": ("pixray_tpu_torch.filters.tiler", "TilerFilter"),
    "wallpaper": ("pixray_tpu_torch.filters.wallpaper", "WallpaperFilter"),
}


def filter_class(name: str) -> type:
    if name not in _FILTER_MODULES:
        raise KeyError(name)
    module_name, class_name = _FILTER_MODULES[name]
    return getattr(importlib.import_module(module_name), class_name)
