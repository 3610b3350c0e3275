"""pixray_tpu_torch — the PyTorch/CUDA port of pixray_tpu, for NVIDIA Hopper.

Public API mirrors ``pixray_tpu``:

    import pixray_tpu_torch as pixray
    pixray.reset_settings()
    pixray.add_settings(prompts="a sunrise", drawer="pixel", clip_models="ViT-B/32")
    settings = pixray.apply_settings()
    pixray.do_init(settings)          # device="cuda" by default
    pixray.do_run(settings)

or the one-liner ``pixray_tpu_torch.run(prompts=..., drawer="pixel")``.
The vqgan (the default), pixel, fast_pixel, fft, clipdraw and line_sketch
drawers with OpenAI ViT perceptors, the lookup, tiler and wallpaper
filters, and every custom loss but style and resmem are ported so far.
"""

from __future__ import annotations

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
    global _engine
    from pixray_tpu_torch.engine.core import Engine

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
