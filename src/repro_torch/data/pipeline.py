# Port copy of repro/data/pipeline.py.  What differs:
# * The process index and count default to 0 and 1 (one process per card)
#   instead of jax.process_index() and jax.process_count().
# * host_local_batch_specs (dry-run stand-ins) is not ported yet (ROADMAP,
#   module item 10).
# Batches stay numpy arrays, exactly JAX's; the trainer moves them to its
# device.
"""Synthetic LM data pipeline: deterministic, host-sharded, prefetching.

Each host materializes only its shard of the global batch (process-local
slice along the batch axis), generated counter-based from (seed, step) so any
host can reproduce any step independently — restart after a crash needs no
data-loader state beyond the step counter (which EasyCrash persists).

A background thread prefetches ``prefetch`` batches ahead so host-side
generation overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    frontend_tokens: int = 0     # VLM patch embeddings prepended by the model
    d_model: int = 0             # needed when frontend_tokens > 0
    prefetch: int = 2


def _batch_for_step(cfg: DataConfig, step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of the global batch for ``step`` (deterministic)."""
    n = hi - lo
    s_text = cfg.seq_len - cfg.frontend_tokens
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    # skip-ahead: draw the full batch lazily by row blocks for determinism
    tokens = rng.integers(0, cfg.vocab, size=(cfg.global_batch, s_text + 1), dtype=np.int32)
    # inject structure so the LM has something learnable: tokens repeat with
    # period 3 within a window (pure-noise streams can't show convergence)
    tokens[:, 2::3] = tokens[:, 1::3][:, : tokens[:, 2::3].shape[1]]
    out: Dict[str, np.ndarray] = {"tokens": tokens[lo:hi]}
    if cfg.frontend_tokens:
        patches = rng.standard_normal((n, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        out["patches"] = patches
    return out


class SyntheticLMStream:
    """Iterator of host-local batches with background prefetch."""

    def __init__(self, cfg: DataConfig, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, start_step: int = 0):
        self.cfg = cfg
        pi = 0 if process_index is None else process_index
        pc = 1 if process_count is None else process_count
        per = cfg.global_batch // pc
        assert per * pc == cfg.global_batch, "global batch must divide host count"
        self.lo, self.hi = pi * per, (pi + 1) * per
        self._lock = threading.Lock()
        self._next_out = start_step    # next step __next__ must return
        self._next_gen = start_step    # next step the producer generates
        self._q: "queue.Queue[Tuple[int, Dict[str, np.ndarray]]]" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                step = self._next_gen
                self._next_gen += 1
            batch = _batch_for_step(self.cfg, step, self.lo, self.hi)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        while True:
            step, batch = self._q.get()
            if step == self._next_out:   # drop anything stale after a seek
                self._next_out = step + 1
                return step, batch

    def seek(self, step: int) -> None:
        """Restart support: resume the stream at an arbitrary step."""
        with self._lock:
            self._next_out = step
            self._next_gen = step
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

