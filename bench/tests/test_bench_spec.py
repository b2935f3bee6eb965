"""BENCHMARK.json and the files it names: its keys, names, units and
limits, and every name found where the harness looks for it."""
import ast
import json
import re

import pytest
from _tiny import ROOT, harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]] \
            + [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


def test_configs_files_and_sizes():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("bench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and "assumed" in body
        assert (harness.HERE / "runners" / f"{body['runner']}.py").is_file()
        for kind in ("reference", "inputs", "counts"):
            assert (harness.HERE / kind / f"{body[kind]}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_enough(cell):
    w = harness.workload(SPEC, cell)
    assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(SPEC, cell, True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    path = harness.metric_reader(metric)
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
    assert harness.read_metric(metric, {"units": [], "trace": None}) is None


def test_a_split_name_falls_back_to_its_base_reader():
    assert harness.metric_reader("device_idle.flushed") == harness.HERE / "metrics" / "device_idle.py"
    assert harness.metric_reader("iter_ms") == harness.HERE / "metrics" / "iter_ms.py"
    assert harness.read_metric("iter_ms.flushed", {"window_s": 2.0, "units": [{}] * 4}) == 500.0


def test_layers_named_alike_per_module():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items() if k not in ("kernel",)), layers


def test_trace_reduction_on_synthetic_events():
    from bench.trace import reduce_events

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.region.update", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.maybe_flush", "ts": 100, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 25, "dur": 15},   # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "dirty_vec16_kernel<x>", "ts": 500, "dur": 5},
    ]
    r = reduce_events(ev, 1e-3)
    assert r["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert r["kernels"]["k1"] == {"seconds": pytest.approx(35e-6), "count": 2}
    gaps = dict(r["idle_gaps"])
    assert gaps["region.update"] == pytest.approx(20e-6)   # 40 .. 60
    assert gaps["maybe_flush"] == pytest.approx(430e-6)    # 70 .. 500, middle at 285
    assert r["device_ops"][0][0] == "k1"
    # the traced window's idle head and tail count too, the window is no span
    ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 2000},
           {"ph": "X", "cat": "user_annotation", "name": "bench.maybe_flush", "ts": 1200,
            "dur": 800}]
    gaps = dict(reduce_events(ev, 2e-3)["idle_gaps"])
    assert gaps["region.update"] == pytest.approx(30e-6)   # 0 .. 10 as well
    assert gaps["maybe_flush"] == pytest.approx((430 + 1495) * 1e-6)  # and 505 .. 2000
    assert "window" not in gaps
