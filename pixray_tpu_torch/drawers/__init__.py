"""The port's drawers: ``pixel``, ``fast_pixel``, ``fft``, ``clipdraw``,
``line_sketch``, ``vqgan``, ``vdiff`` and ``super_resolution``, looked up
in ``pixray_tpu_torch.registry``; another name raises."""

from pixray_tpu_torch.registry import drawer_class

__all__ = ["drawer_class"]
