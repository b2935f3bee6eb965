"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first units of the window, reduced to what the per-layer readers take.

The runners wrap each call into a layer in :func:`span` (a
``record_function`` range named ``bench.<layer>``), traced or not, so a
traced run drives the same code.  The reduction reads the profiler's
Chrome trace: device activity (kernels, copies, fills) as intervals, the
``bench.*`` ranges as the host's spans.  ``busy_s`` is the union of the
device intervals; an idle gap between them, and the idle time from the
traced window's start (a ``bench.window`` range) to the first interval and
from the last to its end, is put down to the innermost ``bench.*`` range
the host was in at the gap's middle.  The program's own ranges (every other
``record_function`` range, such as the port's ``easycrash.*``) are reduced
by name to their host time inside the traced window, their count and the
device time of the work launched inside them (``ranges``).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host calls that launch device work, linked to it by ``correlation``
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench."
#: the range around the traced window itself (``bench.window``)
WINDOW = "window"


def span(name: str):
    """A profiler range around one call into a layer (``bench.<name>``)."""
    return torch.profiler.record_function(PREFIX + name)


class Tracer:
    """``start()`` / ``stop()`` around the traced units; ``reduce()`` after
    the window."""

    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0
        self.running = False

    def start(self) -> None:
        sync(self.device)
        self.prof.__enter__()
        self.window = span(WINDOW)
        self.window.__enter__()
        self.running = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.running = False

    def reduce(self) -> Dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return reduce_events(events, self.window_s)


def sync(device: str) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[Dict], window_s: float) -> Dict:
    """Chrome-trace events -> ``busy_s``, ``window_s``, device time and
    launches by kernel name, the top device ops, the longest idle gaps by
    host span and the program's ranges (seconds).  Times in the trace are
    microseconds."""
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    spans: List[Tuple[float, float, str]] = []
    program: List[Tuple[float, float, str, Tuple]] = []
    launches: Dict[int, Tuple[float, Tuple]] = {}
    launched: List[Tuple[int, float, float]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            row = by_name[e.get("name", "?")]
            row[0] += dur * 1e-6
            row[1] += 1
            if corr is not None:
                launched.append((corr, ts, ts + dur))
        elif cat == "user_annotation":
            name = str(e.get("name", ""))
            if name.startswith(PREFIX):
                spans.append((ts, ts + dur, name[len(PREFIX):]))
            else:
                program.append((ts, ts + dur, name, (e.get("pid"), e.get("tid"))))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, (e.get("pid"), e.get("tid")))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    window = [(a, b) for a, b, name in spans if name == WINDOW]
    spans = sorted(sp for sp in spans if sp[2] != WINDOW)
    edges = busy
    if window and busy:  # the idle head and tail of the traced window
        edges = [(window[0][0], window[0][0])] + busy + [(window[0][1], window[0][1])]
    active: List[Tuple[float, float, str]] = []
    nxt_span = 0
    for (_, end), (nxt, _) in zip(edges, edges[1:]):  # gap middles rise
        if nxt <= end:
            continue
        mid = (end + nxt) / 2
        while nxt_span < len(spans) and spans[nxt_span][0] <= mid:
            active.append(spans[nxt_span])
            nxt_span += 1
        active = [s for s in active if s[1] >= mid]
        name = min(active, key=lambda s: s[1] - s[0])[2] if active else "outside bench spans"
        gaps[name] += (nxt - end) * 1e-6
    ops = sorted(((n, r[0]) for n, r in by_name.items()), key=lambda r: -r[1])
    bounds = window[0] if window else (float("-inf"), float("inf"))
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {n: {"seconds": r[0], "count": int(r[1])} for n, r in by_name.items()},
        "device_ops": [[n[:120], s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda r: -r[1])[:10]],
        "ranges": _program_ranges(program, launches, launched, bounds),
    }


def _program_ranges(ranges: List[Tuple[float, float, str, Tuple]],
                    launches: Dict[int, Tuple[float, Tuple]],
                    launched: List[Tuple[int, float, float]],
                    bounds: Tuple[float, float]) -> Dict[str, Dict]:
    """``{name: {"host_s", "count", "device_s"}}`` of the ranges that
    overlap the traced window (``bounds``, microseconds).  ``host_s`` is the
    part inside the window.  ``device_s`` is the union of the device
    intervals whose launch the range's thread made inside the range and the
    window: a kernel counts in every range around its launch, also where it
    runs after the range has closed."""
    lo, hi = bounds
    ranges = sorted((r for r in ranges if r[0] < hi and r[1] > lo), key=lambda r: r[:2])
    calls: Dict[Tuple, List[Tuple[float, float, float]]] = defaultdict(list)
    for corr, a, b in launched:
        if corr in launches:
            t, thread = launches[corr]
            if lo <= t <= hi:
                calls[thread].append((t, a, b))
    on_device: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for thread, todo in calls.items():
        mine = [(a, b, i) for i, (a, b, _, th) in enumerate(ranges) if th == thread]
        active: List[Tuple[float, float, int]] = []
        nxt = 0
        for t, a, b in sorted(todo):  # launch times rise
            while nxt < len(mine) and mine[nxt][0] <= t:
                active.append(mine[nxt])
                nxt += 1
            active = [r for r in active if r[1] >= t]
            for r in active:
                on_device[r[2]].append((a, b))
    out: Dict[str, Dict] = {}
    for i, (a, b, name, _) in enumerate(ranges):
        row = out.setdefault(name, {"host_s": 0.0, "count": 0, "device_s": 0.0})
        row["host_s"] += (min(b, hi) - max(a, lo)) * 1e-6
        row["count"] += 1
        row["device_s"] += sum(y - x for x, y in _union(on_device[i])) * 1e-6
    return out


def kernel_seconds(trace: Dict, *fragments: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds one of
    ``fragments``."""
    secs, count = 0.0, 0
    for name, row in trace.get("kernels", {}).items():
        if any(f in name for f in fragments):
            secs += row["seconds"]
            count += row["count"]
    return secs, count
