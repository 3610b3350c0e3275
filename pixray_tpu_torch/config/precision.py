"""The precision rungs, read from the JAX package's own variables.

    PIXRAY_TPU_WARP_PREC      int8 | bf16 | high | highest   K1's rung (the cutout bank's forward)
    PIXRAY_TPU_WARP_BWD_PREC  bf16 | int8                    K2 on int8 only with an int8 K1
    PIXRAY_TPU_CLIP_PREC      int8b | int8 | bf16            the ViT vision towers' dense kernels
    PIXRAY_TPU_CLIP_PREQ      1 | 0                          s8 weights made at load, or per call
    PIXRAY_TPU_CLIP_LN32      0 | 1                          bf16 LayerNorm, or float32 statistics

The values and conditions are the JAX package's (``pixray_tpu/ops/pallas_warp.py``,
``pixray_tpu/models/perceptor.py``, ``pixray_tpu/models/clip/model.py``):
K2 and the single-mode warp run ``int8`` as ``bf16`` (``norm_prec``),
and K2 runs int8 only when K1 does, ``WARP_BWD_PREC`` is ``int8`` and the
canvas is tall enough for the JAX backward's 64-row band (``bwd_prec``;
both in ``ops/warp_batch.py``); the CLIP rung acts only on a bf16 ViT tower, never on
the text tower or a ResNet; ``PREQ`` acts only under an int8 rung.

Defaults where a variable is unset (``PORT_DEFAULTS``): the JAX package's
for ``WARP_BWD_PREC`` and ``CLIP_PREQ``; for the other three the port's
own, which differ from the JAX package's (``int8``, ``int8b``, ``0``).
``chip_smoke.py``'s ladder phase measured both settings on an H100 (see
PERF.md and ROADMAP.md for the numbers that decided each).

:func:`read_rungs` reads the environment when an engine or a perceptor
is built and the result is passed down as arguments: nothing reads it at
import, and a captured CUDA graph keeps the rung it was captured with.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from pixray_tpu_torch.ops.warp_batch import WARP_PRECS

PORT_DEFAULTS = {
    "PIXRAY_TPU_WARP_PREC": "highest",
    "PIXRAY_TPU_WARP_BWD_PREC": "bf16",
    "PIXRAY_TPU_CLIP_PREC": "bf16",
    "PIXRAY_TPU_CLIP_PREQ": "1",
    "PIXRAY_TPU_CLIP_LN32": "1",
}


@dataclass(frozen=True)
class Rungs:
    warp: str = "highest"  # K1
    warp_bwd: str = "bf16"  # the value of PIXRAY_TPU_WARP_BWD_PREC
    clip: str = "bf16"  # "int8b", "int8" or anything else (no int8 rung)
    clip_preq: bool = True
    clip_ln32: bool = True

    def clip_quant(self, dtype_is_bf16: bool):
        """The ViT tower's int8 rung ("int8", "int8b") or None."""
        return self.clip if dtype_is_bf16 and self.clip in ("int8", "int8b") else None


def read_rungs(environ=None) -> Rungs:
    """The rungs the environment selects (unset variables: ``PORT_DEFAULTS``)."""
    env = os.environ if environ is None else environ
    get = lambda name: env.get(name, PORT_DEFAULTS[name])
    warp = get("PIXRAY_TPU_WARP_PREC")
    if warp not in WARP_PRECS:
        raise ValueError(f"PIXRAY_TPU_WARP_PREC must be one of {WARP_PRECS}; got {warp!r}")
    return Rungs(warp=warp, warp_bwd=get("PIXRAY_TPU_WARP_BWD_PREC"), clip=get("PIXRAY_TPU_CLIP_PREC"),
                 clip_preq=get("PIXRAY_TPU_CLIP_PREQ") == "1", clip_ln32=get("PIXRAY_TPU_CLIP_LN32") != "0")
