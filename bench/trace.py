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
the host was in at the gap's middle.
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
    launches by kernel name, the top device ops and the longest idle gaps
    by host span (seconds).  Times in the trace are microseconds."""
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            row = by_name[e.get("name", "?")]
            row[0] += dur * 1e-6
            row[1] += 1
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            spans.append((ts, ts + dur, e["name"][len(PREFIX):]))
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
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {n: {"seconds": r[0], "count": int(r[1])} for n, r in by_name.items()},
        "device_ops": [[n[:120], s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda r: -r[1])[:10]],
    }


def kernel_seconds(trace: Dict, *fragments: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds one of
    ``fragments``."""
    secs, count = 0.0, 0
    for name, row in trace.get("kernels", {}).items():
        if any(f in name for f in fragments):
            secs += row["seconds"]
            count += row["count"]
    return secs, count
