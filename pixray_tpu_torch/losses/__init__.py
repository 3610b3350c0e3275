"""The port's losses, looked up in ``pixray_tpu_torch.registry``: every
loss of the JAX package.  ``style`` (STROTSS with VGG16) and ``resmem``
carry frozen weights, which the engine places on its device (``place``)."""

from pixray_tpu_torch.registry import add_custom_loss, loss_class

__all__ = ["add_custom_loss", "loss_class"]
