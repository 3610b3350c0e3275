"""The no-JAX check compares each module's top-level name whole."""

from __future__ import annotations

import subprocess
import sys

from portbench.harness import nojax


def test_top_level_names_compared_whole():
    mods = {"pixray_tpu_torch": 1, "pixray_tpu_torch.engine.core": 1, "jaxtyping": 1, "flaxen": 1,
            "optax_like.x": 1, "torch": 1}
    assert nojax.loaded(mods) == []
    bad = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax.linen": 1, "optax": 1,
           "pixray_tpu": 1, "pixray_tpu.engine": 1}
    assert nojax.loaded({**mods, **bad}) == sorted(bad)


def test_benchmark_modules_import_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.harness.measure, portbench.reference.step, portbench.harness.trace;"
            "from portbench.harness import nojax; print(nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=__file__.rsplit("/portbench/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.step, portbench.reference.drawers.pixel, portbench.reference.drawers.vqgan,"
            " portbench.reference.towers.vit;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('pixray_tpu_torch', 'pixray_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=__file__.rsplit("/portbench/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
