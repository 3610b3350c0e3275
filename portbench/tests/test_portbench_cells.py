"""The harness finds configurations, cells, traffic, limits, metric readers
and layers by name, including ones added as new files."""

from __future__ import annotations

import json
import os

import pytest
from conftest_tiny import tiny_checkout

from portbench.harness import cell as C


def test_benchmark_cells_load_by_name():
    bench = json.load(open(os.path.join(C.ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = C.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.chips == 1
        assert set(cell.limits["limits"]) and int(cell.limits["trace_steps"]) > 0
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.metrics(True):
            assert callable(C.reader(m["name"]).read)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(C.ROOT, c["file"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(C.BENCH_DIR, "metrics", f"{m['name']}.py"))


def test_steady_cells_report_their_layers():
    pixel = {m["name"] for m in C.load("pixel.steady").metrics(True)}
    vqgan = {m["name"] for m in C.load("vqgan.steady").metrics(True)}
    assert "decoder_ms" in vqgan and "decoder_ms" not in pixel
    assert {"towers_ms", "bank_roofline", "step_mfu_pct", "device_idle_pct.steady"} <= pixel


def test_added_cell_and_metric_are_found(tmp_path):
    root, bench_dir = tiny_checkout(tmp_path)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny.more", "config": "tiny_pixel", "traffic": "tiny_more", "chips": 1,
                               "why": "an added cell"})
    bench["per_layer"].append({"name": "added_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "added", "moves": "steps_per_s", "workloads": ["tiny.more"]})
    for m in bench["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("tiny.more")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    with open(os.path.join(bench_dir, "traffic", "tiny_more.json"), "w") as f:
        json.dump({"program": {"num_cuts": 4}, "warmup_steps": 9}, f)
    with open(os.path.join(bench_dir, "workloads", "tiny.more.json"), "w") as f:
        json.dump({"trace_steps": 8, "limits": {"loss_gap": 1e-3}}, f)
    with open(os.path.join(bench_dir, "metrics", "added_ms.py"), "w") as f:
        f.write('LAYERS = ("added",)\n\n\ndef read(run):\n    return 1.5\n')
    with open(os.path.join(bench_dir, "layers", "added.json"), "w") as f:
        json.dump({"target": "pixray_tpu_torch.engine.step:StepBlock.run", "tensor_arg": 1}, f)
    cell = C.load("tiny.more", root=root, bench_dir=bench_dir)
    assert cell.traffic["program"]["num_cuts"] == 4
    assert C.reference_settings(cell)["num_cuts"] == 4
    assert [m["name"] for m in cell.metrics(True)] == ["added_ms"]
    assert C.reader("added_ms", bench_dir).read(None) == 1.5
    assert cell.marked_layers() == ["added"]
    assert C.layers(cell.marked_layers(), bench_dir)["added"]["tensor_arg"] == 1
    # the added layer's markers go only into the cells whose metrics read it
    assert C.load("tiny.pixel", root=root, bench_dir=bench_dir).marked_layers() == ["bank", "towers"]


def test_per_layer_metric_without_workloads_is_refused(tmp_path):
    root, bench_dir = tiny_checkout(tmp_path)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    del bench["per_layer"][0]["workloads"]
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    with pytest.raises(KeyError):
        C.load("tiny.pixel", root=root, bench_dir=bench_dir).metrics(True)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        C.load("no.such.cell")
