from .settings import apply_settings

__all__ = ["apply_settings"]
