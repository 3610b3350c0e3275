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


def test_prepared_default_run_cell_loads(tmp_path):
    """vqgan.default_run's files (traffic, limits, readers) make a cell once BENCHMARK.json names it."""
    bench = json.load(open(os.path.join(C.ROOT, "BENCHMARK.json")))
    assert "vqgan.default_run" not in {w["name"] for w in bench["workloads"]}
    bench["workloads"].append({"name": "vqgan.default_run", "config": "vqgan_f16_16384_clip2",
                               "traffic": "default_run", "chips": 1, "why": "the default run"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("steps_per_s", "towers_ms", "decoder_ms", "bank_roofline", "step_mfu_pct", "build_s",
                         "capture_s"):
            m["workloads"].append("vqgan.default_run")
    for name, layer in (("checkin_ms", "checkin"), ("device_idle_pct.run", "device")):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                                   "layer": layer, "moves": "steps_per_s", "workloads": ["vqgan.default_run"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = C.load("vqgan.default_run", root=str(tmp_path))
    assert {m["name"] for m in cell.metrics(False)} == {"steps_per_s", "setup_s"}
    for m in cell.metrics(True):
        assert callable(C.reader(m["name"]).read)
    assert cell.marked_layers() == ["bank", "decoder", "towers"]
    assert C.start(cell) == "program" and C.start(C.load("vqgan.steady")) == "seed"
    assert C.start_spec(cell)["tensor_arg"] == 1
    settings = C.reference_settings(cell)
    assert settings["vector_prompts"] == ["textoff"] and settings["init_noise"] == "pixels"
    assert settings["num_cuts"] == 30 and int(cell.limits["trace_steps"]) == 20


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
