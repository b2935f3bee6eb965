"""The general part of a run: find the cell's files by name, set up, measure
the window, check the output, read the metrics and compose the result.

A runner (``runners/<name>.py``, named by the configuration) provides
``setup(config, traffic, seed, device)``, ``window(session, seconds,
tracer)``, ``after_window(session, rec)``, ``check(session, rec, limits)``,
``control(session, rec)`` (the control's readings, ``control.py``) and
``tiny(config, traffic) -> (config, traffic)``, the cell at a size the CPU
tests run in a second.  A metric is ``metrics/<name>.py`` with
``read(rec)``, which returns ``None`` where it finds nothing to read.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """One number of the output check, held to ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def subseed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any integer)."""
    text = ":".join([str(int(seed)), *map(str, purpose)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build caches at fixed paths inside the checkout (``build/`` is not
    committed).  The port's kernels build into ``build/repro_torch``."""
    base = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (on)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def wanted(m: Dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in spec["per_layer"] if wanted(m)]


def metric_reader(name: str) -> Path:
    """``metrics/<name>.py``, or for a split name ``<base>.<part>`` with no
    file of its own, ``metrics/<base>.py``: one reader serves every split."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def read_metric(name: str, rec: Dict) -> Optional[float]:
    path = metric_reader(name)
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(rec)
    return None if value is None else float(value)


def device_info(device: str) -> Dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config: Optional[Dict] = None, traffic: Optional[Dict] = None,
             limits: Optional[Dict] = None, spec: Optional[Dict] = None,
             t0: Optional[float] = None, control: bool = False) -> Dict:
    """Run one cell once; returns the result line (a dict) and, under
    ``"_checks"``, the :class:`Check` list.  ``config``, ``traffic`` and
    ``limits`` replace the files (the CPU tests run tiny sizes).  With
    ``control``, ``"_control"`` holds the control's readings on the same
    outputs (``control.py``; a run of the benchmark never computes them)."""
    import torch

    from .trace import Tracer

    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or load_spec()
    w = workload(spec, cell)
    config = config or load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = limits or load_json(HERE / "limits" / f"{cell}.json")
    runner = importlib.import_module(f"bench.runners.{config['runner']}")
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    session = runner.setup(config, traffic, seed, device)
    rec: Dict = {"setup_s": time.perf_counter() - t0}
    tracer = Tracer(device) if trace else None
    rec.update(runner.window(session, seconds, tracer))
    runner.after_window(session, rec)
    dev = device_info(device)
    checks = runner.check(session, rec, limits)
    readings = runner.control(session, rec) if control else None
    del session
    if tracer is not None:
        rec["trace"] = tracer.reduce()
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": all(c.ok for c in checks),
        "attempted": int(rec["attempted"]),
        "failed": int(rec.get("failed", 0)),
        "metrics": metrics,
        "device": dev,
    }
    if tracer is not None:
        out["breakdown"] = {k: rec["trace"][k] for k in ("device_ops", "idle_gaps")}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    out["_checks"] = checks
    if control:
        out["_control"] = readings
    return out
