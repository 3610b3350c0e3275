"""The port runs with JAX, flax, optax and pixray_tpu unimportable — as on a
GPU machine that has none of them.  PIL, PyYAML, regex and ftfy are blocked
too: the port's main path must not need them.

A subprocess installs an import hook that refuses those modules, imports
pixray_tpu_torch and runs a slice for 2 steps on the CPU at TinyTest size
through the public API: the pixel slice, and the clipdraw slice with its
SVG export.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex", "pixray_tpu", "PIL", "yaml", "regex", "ftfy")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import pixray_tpu_torch as pixray

    pixray.reset_settings()
    pixray.add_settings(prompts="sunrise", clip_models="TinyTest", size=[64, 36],
                        num_cuts=8, iterations=2, save_every=1, seed=3, outdir=OUTDIR,
                        save_intermediates=False, learning_rate_drops=[], vector_prompts="none",
                        **DRAWER)
    settings = pixray.apply_settings()
    pixray.do_init(settings, device="cpu")
    assert pixray.do_run(settings)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def _run_blocked(tmp_path, drawer: dict):
    outdir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", f"OUTDIR = {outdir!r}\nDRAWER = {drawer!r}\n" + SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "iter: 2" in proc.stdout  # the final checkin
    with open(os.path.join(outdir, "output.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    return outdir


def test_port_runs_without_jax(tmp_path):
    _run_blocked(tmp_path, dict(drawer="pixel"))


def test_clipdraw_runs_without_jax(tmp_path):
    outdir = _run_blocked(tmp_path, dict(drawer="clipdraw", strokes=12, save_svg=True))
    with open(os.path.join(outdir, "output.svg")) as f:
        assert f.read().count("<path ") == 12
