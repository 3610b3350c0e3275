"""The tiny test cells: the benchmark's ``BENCHMARK.json`` with each cell
swapped for its tiny counterpart of ``tiny/``, and the prepared
default-run cell's (``tiny.run``) added, beside a copy of the
benchmark folder's readers, layers and starts, in a temporary checkout.
The tiny vector prompt ``tinyoff`` (``tiny/vectors/``, a row for TinyTest)
is found where ``$PIXRAY_TPU_VECTORS`` points (``tiny_vectors``)."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

# a cell of BENCHMARK.json: its tiny cell, the tiny configuration and traffic mix
TINY = {"pixel.steady": ("tiny.pixel", "tiny_pixel", "tiny_steady"),
        "vqgan.steady": ("tiny.vqgan", "tiny_vqgan", "tiny_steady")}
# the prepared cell vqgan.default_run (traffic and limits in this folder, no entry in BENCHMARK.json):
# its tiny cell starts from the program's latent, encodes a noise init and reads a vector prompt
PREPARED = {"name": "tiny.run", "config": "tiny_vqgan", "traffic": "tiny_run", "chips": 1,
            "why": "the prepared default-run cell at a tiny size"}


def tiny_benchmark() -> dict:
    """BENCHMARK.json with its cells and configurations swapped for the tiny ones."""
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = [w for w in bench["workloads"] if w["name"] in TINY]
    bench["workloads"] = [dict(w, name=TINY[w["name"]][0], config=TINY[w["name"]][1], traffic=TINY[w["name"]][2])
                          for w in cells]
    bench["configs"] = [{"name": c, "source": "portbench/tests/tiny", "file": f"portbench/tests/tiny/configs/{c}.json",
                         "reduced": [], "why": "a tiny CPU test configuration"}
                        for c in sorted({w["config"] for w in bench["workloads"]})]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w][0] for w in m["workloads"] if w in TINY]
    bench["workloads"].append(PREPARED)
    next(m for m in bench["end_to_end"] if m["name"] == "steps_per_s")["workloads"].append(PREPARED["name"])
    return bench


def tiny_checkout(tmp_path) -> tuple[str, str]:
    """(root, bench_dir) of a temporary checkout holding the tiny cells."""
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(os.path.join(HERE, "tiny"), bench)
    for sub in ("metrics", "layers", "starts"):
        shutil.copytree(os.path.join(BENCH, sub), bench / sub)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(tiny_benchmark(), f, indent=1)
    return str(root), str(bench)


def tiny_vectors(bench_dir: str) -> dict:
    """The environment under which the program and the reference find the tiny vector prompts."""
    return {"PIXRAY_TPU_VECTORS": os.path.join(bench_dir, "vectors")}
