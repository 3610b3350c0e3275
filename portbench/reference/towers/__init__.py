"""Image towers by kind.  A configuration's tower entry may name its kind
(``vision_kind``; ``"vit"`` where it names none); the kind is the module
``reference/towers/<kind>.py``, found by name.  Each kind gives:

- ``Visual(d)``: the plain float32 image tower under OpenAI's state-dict
  names below ``visual.``: standardized (N, 3, S, S) cutouts → (N, D);
- ``init_rule(name, shape, d)``: the initialiser of one of its tensors
  (``name`` below ``visual.``): ``("normal", std)``, ``("ones",)`` or
  ``("zeros",)``, at the scales of the program's seeded initialisation;
- ``image_flops(d)``: one image's forward FLOPs as ``{"linear": ...,
  "attention": ...}``: the products whose other operand is a constant
  (weights), and those whose operands both depend on the image.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_KIND = "vit"


def kind_of(d: dict) -> str:
    return d.get("vision_kind", DEFAULT_KIND)


def module(kind: str, bench_dir: str | None = None):
    """The module of a tower kind: ``reference/towers/<kind>.py`` of the
    benchmark folder ``bench_dir`` where it has one, else of this folder."""
    dirs = ([os.path.join(bench_dir, "reference", "towers")] if bench_dir else []) + [HERE]
    for base in dirs:
        path = os.path.join(base, f"{kind}.py")
        if not os.path.exists(path):
            continue
        name = f"portbench.reference.towers.{kind}"
        mod = sys.modules.get(name)
        if mod is not None and os.path.abspath(getattr(mod, "__file__", "")) == os.path.abspath(path):
            return mod
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod
    raise KeyError(f"no tower kind {kind!r} (no {kind}.py in {dirs})")
