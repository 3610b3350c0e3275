"""Extension-point registries of the port: drawers, losses, filters.

The one table of the port's plug-ins (``pixray_tpu/registry.py``'s
names): ``load_registries()`` imports every module below into
``DRAWER_CLASSES``, ``LOSS_CLASSES`` and ``FILTER_CLASSES`` (idempotent);
a module that fails to import is skipped with a console note, as the JAX
package skips an optional drawer.  ``drawer_class``, ``loss_class`` and
``filter_class`` look a name up after loading them.
"""

from __future__ import annotations

import importlib

DRAWER_CLASSES: dict[str, type] = {}
LOSS_CLASSES: dict[str, type] = {}
FILTER_CLASSES: dict[str, type] = {}

_DRAWER_MODULES = {
    "fast_pixel": ("pixray_tpu_torch.drawers.fast_pixel", "FastPixelDrawer"),
    "pixel": ("pixray_tpu_torch.drawers.pixel", "PixelDrawer"),
    "fft": ("pixray_tpu_torch.drawers.fft", "FftDrawer"),
    "vqgan": ("pixray_tpu_torch.drawers.vqgan", "VqganDrawer"),
    "clipdraw": ("pixray_tpu_torch.drawers.clipdraw", "ClipDrawer"),
    "line_sketch": ("pixray_tpu_torch.drawers.line_sketch", "LineDrawer"),
    "vdiff": ("pixray_tpu_torch.drawers.vdiff", "VdiffDrawer"),
    "super_resolution": ("pixray_tpu_torch.drawers.super_resolution", "SuperResolutionDrawer"),
}

_LOSS_MODULES = {
    "palette": ("pixray_tpu_torch.losses.palette", "PaletteLoss"),
    "saturation": ("pixray_tpu_torch.losses.saturation", "SaturationLoss"),
    "symmetry": ("pixray_tpu_torch.losses.symmetry", "SymmetryLoss"),
    "smoothness": ("pixray_tpu_torch.losses.smoothness", "SmoothnessLoss"),
    "edge": ("pixray_tpu_torch.losses.edge", "EdgeLoss"),
    "style": ("pixray_tpu_torch.losses.style", "StyleLoss"),
    "resmem": ("pixray_tpu_torch.losses.resmem", "ResmemLoss"),
    "aesthetic": ("pixray_tpu_torch.losses.aesthetic", "AestheticLoss"),
    "gaussian": ("pixray_tpu_torch.losses.gaussian", "GaussianLoss"),
}

_FILTER_MODULES = {
    "lookup": ("pixray_tpu_torch.filters.lookup", "ColorLookup"),
    "tiler": ("pixray_tpu_torch.filters.tiler", "TilerFilter"),
    "wallpaper": ("pixray_tpu_torch.filters.wallpaper", "WallpaperFilter"),
}


def _populate(table: dict, modules: dict, kind: str) -> None:
    for name, (module_name, class_name) in modules.items():
        if name in table:
            continue
        try:
            module = importlib.import_module(module_name)
            table[name] = getattr(module, class_name)
        except ImportError as e:  # the JAX package's soft fail
            print(f"--> {kind} '{name}' not supported: {e}")


def load_registries() -> None:
    """Populate all registries (idempotent)."""
    _populate(DRAWER_CLASSES, _DRAWER_MODULES, "drawer")
    _populate(LOSS_CLASSES, _LOSS_MODULES, "loss")
    _populate(FILTER_CLASSES, _FILTER_MODULES, "filter")


def add_custom_loss(name: str, loss_class: type) -> None:
    """Runtime loss registration; a name of the table is replaced."""
    from pixray_tpu_torch.losses.base import LossInterface

    if not issubclass(loss_class, LossInterface):
        raise TypeError(f"{loss_class!r} is not a LossInterface")
    LOSS_CLASSES[name] = loss_class


def drawer_class(name: str) -> type:
    load_registries()
    if name not in DRAWER_CLASSES:
        raise NotImplementedError(f"drawer {name!r} is not a drawer of pixray_tpu_torch (have {sorted(DRAWER_CLASSES)})")
    return DRAWER_CLASSES[name]


def loss_class(name: str) -> type:
    load_registries()
    return LOSS_CLASSES[name]


def filter_class(name: str) -> type:
    load_registries()
    return FILTER_CLASSES[name]
