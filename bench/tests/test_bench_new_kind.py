"""A configuration of another kind than the heat cells' joins the benchmark
by new files and ``BENCHMARK.json`` entries alone: here a stand-in runner of
repeated matrix products, with no ``app_args``, its own metrics (one read
from the device trace) and its own limits.  The benchmark is copied under
``tmp_path`` and the new files are added beside the copies, so no file of
``bench/`` is edited; the existing tests then take the new cell as it is."""
import copy
import importlib.util
import json
import shutil
import sys

import pytest
import test_bench_control
import test_bench_runners
import test_bench_spec
from _tiny import harness, tiny

CELL = "stub-products"

RUNNER = '''"""Repeated products of a seeded matrix and vector."""
import time
from types import SimpleNamespace

import torch

from bench.harness import Check, subseed
from bench.trace import span, sync


def setup(config, traffic, seed, device):
    g = torch.Generator().manual_seed(subseed(seed, "stub"))
    n = int(config["width"])
    return SimpleNamespace(device=device, a=torch.randn(n, n, generator=g).to(device),
                           x=torch.randn(n, generator=g).to(device), y=None)


def window(s, seconds, tracer):
    units = []
    if tracer is not None:
        tracer.start()
    t_w0 = time.perf_counter()
    while not units or time.perf_counter() - t_w0 < seconds:
        t0 = time.perf_counter()
        with span("product"):
            s.y = s.a @ s.x
        sync(s.device)
        time.sleep(1e-3)  # a paced stream: a product a millisecond
        units.append({"op_s": time.perf_counter() - t0,
                      "traced": bool(tracer is not None and tracer.running)})
        if tracer is not None and tracer.running and len(units) >= 4:
            tracer.stop()
    return {"window_s": time.perf_counter() - t_w0, "units": units, "attempted": len(units)}


def after_window(s, rec):
    pass


def _gap(s, y):
    want = s.a.double() @ s.x.double()
    return float((y.double() - want).abs().max() / want.abs().max())


def check(s, rec, limits):
    return [Check("product_gap", _gap(s, s.y), float(limits["product_gap"]))]


def control(s, rec):
    return {"product_gap": _gap(s, s.a.bfloat16() @ s.x.bfloat16())}


def tiny(config, traffic):
    return dict(config, width=16), traffic
'''

FILES = {
    "configs/stub-kind.json": json.dumps({
        "name": "stub-kind", "source": "https://example.org/stub-kind", "runner": "stub_kind",
        "reference": "stub_kind", "inputs": "stub_kind", "counts": "stub_kind",
        "width": 4096, "reduced": [], "assumed": {"width": "a stand-in's size"}}),
    "traffic/stub-mix.json": json.dumps({"products": "back to back"}),
    "limits/stub-products.json": json.dumps({"product_gap": 1e-4}),
    "runners/stub_kind.py": RUNNER,
    "reference/stub_kind.py": '"""The product in float64 (in the runner\'s check)."""\n',
    "inputs/stub_kind.py": '"""A seeded matrix and vector (in the runner\'s set-up)."""\n',
    "counts/stub_kind.py": '"""No counts."""\n',
    "metrics/stub_op_ms.py": ("from bench.metrics._lib import untraced_mean_ms\n\n\n"
                              "def read(rec):\n    return untraced_mean_ms(rec, 'op_s')\n"),
    "metrics/stub_products.py": "def read(rec):\n    return len(rec.get('units', [])) or None\n",
    "metrics/stub_roofline.py": ("from bench.trace import kernel_seconds\n\n\n"
                                 "def read(rec):\n    trace = rec.get('trace')\n"
                                 "    secs = kernel_seconds(trace, 'gemv')[0] if trace else 0\n"
                                 "    return 1e-3 / secs if secs else None\n"),
}

ENTRIES = {
    "configs": {"name": "stub-kind", "source": "https://example.org/stub-kind",
                "file": "bench/configs/stub-kind.json", "reduced": [],
                "why": "a stand-in of another kind: no app, no app_args"},
    "workloads": {"name": CELL, "config": "stub-kind", "traffic": "stub-mix", "chips": 1,
                  "why": "products back to back"},
    "end_to_end": {"name": "stub_op_ms", "unit": "ms", "better": "lower", "bound": 0.01,
                   "source": "host_clock", "workloads": [CELL]},
    "per_layer": [
        {"name": "stub_products", "unit": "products", "better": "higher",
         "source": "program_counter", "layer": "stub: products", "moves": "stub_op_ms",
         "workloads": [CELL]},
        {"name": "stub_roofline", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "stub: products", "moves": "stub_op_ms", "workloads": [CELL]},
    ],
}


@pytest.fixture
def stub_kind(tmp_path, monkeypatch):
    """The benchmark copied under ``tmp_path`` with the stub's files and
    entries added; the harness and the test modules look there."""
    here = tmp_path / "bench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for rel, text in FILES.items():
        (here / rel).write_text(text)
    spec = harness.load_spec()
    for key, entry in ENTRIES.items():
        spec[key] += entry if isinstance(entry, list) else [entry]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mod_spec = importlib.util.spec_from_file_location("bench.runners.stub_kind",
                                                      here / "runners" / "stub_kind.py")
    runner = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(runner)
    monkeypatch.setitem(sys.modules, "bench.runners.stub_kind", runner)
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "load_spec", lambda root=None: copy.deepcopy(spec))
    monkeypatch.setattr(test_bench_spec, "ROOT", tmp_path)
    monkeypatch.setattr(test_bench_spec, "SPEC", spec)
    monkeypatch.setattr(test_bench_spec, "CELLS", [w["name"] for w in spec["workloads"]])
    return spec


def test_tiny_takes_the_runner_sizes(stub_kind):
    cfg, tr = tiny(CELL)
    assert cfg["width"] == 16 and "app_args" not in cfg and tr == {"products": "back to back"}
    assert tiny("heat-32768-flush8")[0]["app_args"]["grid"] == 64


def test_spec_tests_find_the_new_files(stub_kind):
    test_bench_spec.test_names_units_and_lines()
    test_bench_spec.test_entry_keys()
    test_bench_spec.test_configs_files_and_sizes()
    test_bench_spec.test_layers_named_alike_per_module()
    test_bench_spec.test_cell_finds_its_files_and_reports_enough(CELL)
    for m in ENTRIES["per_layer"] + [ENTRIES["end_to_end"]]:
        test_bench_spec.test_every_metric_has_a_reader(m["name"])


@pytest.mark.parametrize("test", [
    test_bench_runners.test_tiny_run_is_correct_and_reports_its_metrics,
    test_bench_runners.test_tiny_traced_run_reads_host_metrics,
    test_bench_control.test_control_fails_the_limit,
], ids=lambda f: f.__name__)
def test_runner_tests_take_the_new_cell(stub_kind, test):
    test(CELL)
