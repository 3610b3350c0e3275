"""A cell of ``BENCHMARK.json`` and the files it is made of.

Everything is found by name: the cell's entry in ``BENCHMARK.json``, its
configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its limits and start ``workloads/<cell>.json``, each
metric's reader ``metrics/<metric>.py``, each layer a reader marks
``layers/<layer>.json`` and, for a cell that starts from the program's
latent, its drawer's ``starts/<drawer>.json``.  A later cell or metric is
new files and new entries; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json's "workloads"
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json
    benchmark: dict  # BENCHMARK.json
    root: str = ROOT  # the checkout
    bench_dir: str = BENCH_DIR  # this folder

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics a run of this cell reports: its end-to-end metrics
        (those without a ``workloads`` list in every cell), or with
        ``trace`` the per-layer ones whose ``workloads`` list names it."""
        if trace:
            return [m for m in self.benchmark["per_layer"] if self.name in m["workloads"]]
        return [m for m in self.benchmark["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def marked_layers(self) -> list[str]:
        """The layers whose markers the cell's per-layer readers read (each
        reader's ``LAYERS``); a traced run installs these and no others."""
        return sorted({layer for m in self.metrics(True)
                       for layer in getattr(reader(m["name"], self.bench_dir), "LAYERS", ())})


def load(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    bench = _json(root, "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    return Cell(name, entry, _json(bench_dir, "configs", f"{entry['config']}.json"),
                _json(bench_dir, "traffic", f"{entry['traffic']}.json"),
                _json(bench_dir, "workloads", f"{name}.json"), bench, root, bench_dir)


def program_settings(cell: Cell, seed: int, outdir: str) -> dict:
    """The program's settings: the configuration's, then the traffic's over them."""
    return dict(cell.config["program"], **cell.traffic["program"], seed=seed, outdir=outdir)


def reference_settings(cell: Cell) -> dict:
    """What the plain reference reads of a cell: the program settings that
    shape the step, each tower's sizes, the drawer's model sizes, the
    vector prompts' names (as the program splits them), and where the
    checkout and the benchmark folder are (the vector files, the tower
    kinds)."""
    prog = dict(cell.config["program"], **cell.traffic["program"])
    prompts = prog.get("prompts", "")
    vectors = prog.get("vector_prompts") or "none"
    return {
        "drawer": prog["drawer"],
        "size": prog["size"],
        "pixel_size": prog.get("pixel_size"),
        "learning_rate": prog["learning_rate"],
        "init_noise": prog.get("init_noise"),
        "prompts": [p.strip() for p in prompts.split("|") if p.strip()],
        "vector_prompts": [] if vectors.lower() in ("none", "0") else [p.strip() for p in vectors.split("|")],
        "clip_models": [m.strip() for m in prog["clip_models"].split(",")],
        "num_cuts": prog["num_cuts"],
        "towers": cell.config["towers"],
        "vqgan_dims": cell.config.get("vqgan"),
        "root": cell.root,
        "bench_dir": cell.bench_dir,
    }


def start(cell: Cell) -> str:
    """Where the reference starts: ``"seed"`` (the drawer's initial latent
    drawn again from the seed) or ``"program"`` (the program's initial
    latent, its init checked by itself): ``workloads/<cell>.json``'s ``start``."""
    return cell.limits.get("start", "seed")


def start_spec(cell: Cell) -> dict:
    """The drawer's encoding of an init image, for a cell that starts from
    the program's latent: ``starts/<drawer>.json``, the program function
    (``module:attr``) and the index of its tensor argument, the encoding
    before quantization."""
    return _json(cell.bench_dir, "starts", f"{cell.config['program']['drawer']}.json")


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The reader module of a metric: ``metrics/<metric>.py``, whose
    ``read(run)`` returns the value or None where it finds nothing to read."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layers(names, bench_dir: str = BENCH_DIR) -> dict:
    """{layer: its marker entry} from ``layers/<layer>.json`` for each of ``names``."""
    return {name: _json(bench_dir, "layers", f"{name}.json") for name in names}
