"""pixray_tpu_torch — the PyTorch/CUDA port of pixray_tpu, for NVIDIA Hopper.

Public API mirrors ``pixray_tpu``:

    import pixray_tpu_torch as pixray
    pixray.reset_settings()
    pixray.add_settings(prompts="a sunrise", drawer="pixel", clip_models="ViT-B/32")
    settings = pixray.apply_settings()
    pixray.do_init(settings)          # device="cuda" by default
    pixray.do_run(settings)

or the one-liner ``pixray_tpu_torch.run(prompts=..., drawer="pixel")``.
Every drawer, loss, filter and perceptor of the JAX package is ported.
The front ends, each on the card unless the caller passes the CPU:

- ``python -m pixray_tpu_torch`` (flags, ``--config_file``), always CUDA;
- ``python -m pixray_tpu_torch.run settings.yaml [outdir] [--device cpu]``;
- ``pixray_tpu_torch.serve``: the Cog products (``PRODUCTS``, built with
  ``device=``) and ``python -m pixray_tpu_torch.serve.http`` (``--device``);
- ``python -m pixray_tpu_torch.tools.vectorize`` (``--device``);
- ``python -m pixray_tpu_torch.parallel.sweep`` (``--device``; its
  ``--dry_run`` imports no torch).
"""

from __future__ import annotations

import gc

from pixray_tpu_torch.registry import add_custom_loss  # noqa: F401

_global_settings: dict = {}
_engine = None


def reset_settings():
    global _global_settings
    _global_settings = {}


def add_settings(**kwargs):
    _global_settings.update(kwargs)


def get_settings() -> dict:
    return _global_settings.copy()


def apply_settings():
    from pixray_tpu_torch.config import apply_settings as _apply

    return _apply(_global_settings)


def do_init(settings, device="cuda"):
    """Build the session's engine; the previous one (its towers, graphs and
    their memory pools) is released first, so a server or a sweep holds
    one engine at a time."""
    global _engine
    from pixray_tpu_torch.engine.core import Engine

    _engine = None
    gc.collect()
    _engine = Engine(settings, device=device)
    return _engine


def do_run(settings, return_display: bool = False) -> bool:
    """Run the engine; with ``return_display`` it returns False every
    ``display_every`` steps (call again for the rest) and True at the end."""
    if _engine is None:
        raise RuntimeError("call do_init first")
    return _engine.run(return_display=return_display)


def get_engine():
    return _engine


def run(prompts=None, drawer="vqgan", device="cuda", **kwargs):
    """One-stop API: resolve settings, build the engine, run it."""
    reset_settings()
    add_settings(prompts=prompts, drawer=drawer, **kwargs)
    settings = apply_settings()
    do_init(settings, device=device)
    return do_run(settings)


def command_line_override():
    """Parse settings purely from argv."""
    reset_settings()
    return apply_settings()


def main():
    """CLI entry point: settings come from argv (+ optional --config_file YAML)."""
    reset_settings()
    settings = apply_settings()
    print(
        f"Running with {settings.num_cuts}x{settings.batches} = "
        f"{settings.num_cuts * settings.batches} cuts"
    )
    do_init(settings)
    do_run(settings)


__version__ = "0.1.0"
