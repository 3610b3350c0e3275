"""The port's filters (``lookup``, ``tiler``, ``wallpaper``), looked up in
``pixray_tpu_torch.registry``."""

from pixray_tpu_torch.registry import filter_class

__all__ = ["filter_class"]
