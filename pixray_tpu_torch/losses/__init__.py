"""Loss registry of the port (``pixray_tpu/registry.py``'s loss table).

``style`` (STROTSS, with its VGG) and ``resmem`` are not ported yet and
raise ``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

import importlib

_LOSS_MODULES = {
    "palette": ("pixray_tpu_torch.losses.palette", "PaletteLoss"),
    "saturation": ("pixray_tpu_torch.losses.saturation", "SaturationLoss"),
    "symmetry": ("pixray_tpu_torch.losses.symmetry", "SymmetryLoss"),
    "smoothness": ("pixray_tpu_torch.losses.smoothness", "SmoothnessLoss"),
    "edge": ("pixray_tpu_torch.losses.edge", "EdgeLoss"),
    "aesthetic": ("pixray_tpu_torch.losses.aesthetic", "AestheticLoss"),
    "gaussian": ("pixray_tpu_torch.losses.gaussian", "GaussianLoss"),
}
_NOT_PORTED = ("style", "resmem")
_CUSTOM: dict[str, type] = {}


def loss_class(name: str) -> type:
    if name in _CUSTOM:
        return _CUSTOM[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"loss {name!r} is not yet ported to pixray_tpu_torch")
    if name not in _LOSS_MODULES:
        raise KeyError(name)
    module_name, class_name = _LOSS_MODULES[name]
    return getattr(importlib.import_module(module_name), class_name)


def add_custom_loss(name: str, loss_class_: type) -> None:
    """Runtime loss registration."""
    from pixray_tpu_torch.losses.base import LossInterface

    assert issubclass(loss_class_, LossInterface)
    _CUSTOM[name] = loss_class_
