# Port copy of repro/core/trace_cache.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Cross-campaign window-trace cache.

A workflow is W+2 campaigns over the *same* application, and the robustness
matrix replays one persist plan under every fault model: most of the crash
windows those runs simulate are identical work.  Historically each
:class:`~repro.core.crash_tester.CrashTester` kept a private per-campaign
window cache, so the same window was re-simulated once per campaign and —
under the process-pool schedulers — once per worker that touched it.

This module shares that work at process scope, in two layers keyed by
content fingerprints:

* **payload layer** — the *application* side of a window: re-running the
  region functions over iterations ``[first, last]`` and snapshotting each
  region occurrence's written values (``seq_values``).  This is independent
  of the persist plan and of the cache-simulation engine, so a workflow's
  baseline / persist-everywhere / per-region campaigns all share it.
* **trace layer** — the simulated :class:`~repro.core.cache_sim.WindowTrace`
  plus its ``seq_values``, keyed additionally by the cache geometry, the
  window's *effective flush schedule* (which flushes actually fire inside
  the window — plans that fire no flush in a window share the baseline
  trace), and the engine.  Replaying a plan under a different fault model,
  re-running a campaign, or robustness-matrix sweeps hit this layer outright.

Keys carry an *app token* — a monotonically increasing id handed out per
live app object through a :class:`weakref.WeakKeyDictionary` — plus the
tester's state digest.  The token ties a cache entry to one concrete app
instance (solver parameters and all); the digest ties it to the golden
trajectory's initial state.  Tokens are never reused, so a collected app's
entries simply age out of the LRU.

Everything cached is treated as immutable by contract: the resolvers only
read ``seq_values`` and the trace arrays, and snapshot copies before
mutating images.
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


class WindowPayload(NamedTuple):
    """Plan-independent result of re-running one window's regions."""

    seq_values: Dict[int, Dict[str, np.ndarray]]
    obj_blocks: Dict[str, int]
    #: (seq, iter_idx, region_idx) per region occurrence, in execution order
    meta: Tuple[Tuple[int, int, int], ...]


class WindowTraceCache:
    """Process-local two-layer LRU over window payloads and traces.

    Thread-safe (the workflow orchestrator's result callbacks land on the
    executor's waiter threads).  ``max_traces`` / ``max_payloads`` bound the
    resident entries; both layers hold full per-region object snapshots, so
    the caps — not entry sizes — are the memory knob.
    """

    def __init__(self, max_traces: int = 128, max_payloads: int = 32):
        self.max_traces = max_traces
        self.max_payloads = max_payloads
        self._traces: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._payloads: "OrderedDict[tuple, WindowPayload]" = OrderedDict()
        self._lock = threading.Lock()
        self._app_tokens: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._next_token = 0
        self.hits = 0
        self.misses = 0
        self.payload_hits = 0
        self.payload_misses = 0

    # ------------------------------------------------------------------ keys
    def app_token(self, app) -> int:
        """Stable, never-reused id for one live app object."""
        with self._lock:
            tok = self._app_tokens.get(app)
            if tok is None:
                tok = self._next_token
                self._next_token += 1
                self._app_tokens[app] = tok
            return tok

    # --------------------------------------------------------------- payloads
    def get_payload(self, key: tuple) -> Optional[WindowPayload]:
        with self._lock:
            p = self._payloads.get(key)
            if p is not None:
                self._payloads.move_to_end(key)
                self.payload_hits += 1
            else:
                self.payload_misses += 1
            return p

    def put_payload(self, key: tuple, payload: WindowPayload) -> None:
        if self.max_payloads <= 0:
            return
        with self._lock:
            self._payloads[key] = payload
            self._payloads.move_to_end(key)
            while len(self._payloads) > self.max_payloads:
                self._payloads.popitem(last=False)

    # ----------------------------------------------------------------- traces
    def get_trace(self, key: tuple) -> Optional[tuple]:
        """Returns ``(trace, seq_values, crash_span_start)`` or ``None``."""
        with self._lock:
            entry = self._traces.get(key)
            if entry is not None:
                self._traces.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return entry

    def put_trace(self, key: tuple, entry: tuple) -> None:
        if self.max_traces <= 0:
            return
        with self._lock:
            self._traces[key] = entry
            self._traces.move_to_end(key)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    # ------------------------------------------------------------------ admin
    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._payloads.clear()
            self.hits = self.misses = 0
            self.payload_hits = self.payload_misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "traces": len(self._traces),
                "payloads": len(self._payloads),
                "hits": self.hits,
                "misses": self.misses,
                "payload_hits": self.payload_hits,
                "payload_misses": self.payload_misses,
            }


_SHARED: Optional[WindowTraceCache] = None
_SHARED_LOCK = threading.Lock()


def shared_trace_cache() -> WindowTraceCache:
    """The process-wide cache (one per worker process, one in the parent).

    ``REPRO_TRACE_CACHE=N`` caps the trace layer (0 disables both layers);
    the payload cap scales as ``max(4, N // 4)``.
    """
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            try:
                n = int(os.environ.get("REPRO_TRACE_CACHE", "128"))
            except ValueError:
                n = 128
            _SHARED = WindowTraceCache(
                max_traces=n, max_payloads=max(4, n // 4) if n > 0 else 0
            )
        return _SHARED
