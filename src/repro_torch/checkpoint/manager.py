# Port copy of repro/checkpoint/manager.py.  What differs: a tree's leaves
# may be torch tensors (serialization.save_pytree copies each to the host),
# and the docstrings name the port's modules.  The leaves restore() returns
# are numpy arrays, as JAX's are; the caller puts them on its device.
"""Multilevel asynchronous checkpoint manager.

Two tiers (paper §7 assumes exactly this):

* **local** — fast tier (node-local SSD / burst buffer): written
  synchronously-cheap via a background thread, committed atomically by
  directory rename;
* **remote** — slow tier (parallel FS): the local checkpoint is *drained*
  to the remote tier asynchronously, off the critical path.

Retention keeps the newest ``keep`` checkpoints per tier.  ``restore()``
prefers the newest complete local checkpoint and falls back to remote —
together with the EasyCrash arena this forms the three-level recovery
hierarchy: arena (NVM) -> local checkpoint -> remote checkpoint.

Commits go through the :mod:`repro_torch.core.durable` replace path (data fsync,
atomic rename, directory fsync), so a checkpoint either exists completely or
not at all — even across ``kill -9`` mid-write or power loss.  Each local
write is also *timed*: :meth:`CheckpointManager.mean_save_seconds` and
:func:`measure_checkpoint_cost` turn the manager into the measurement
instrument that feeds :class:`~repro_torch.core.efficiency.SystemConfig` a real
``T_chk`` (:func:`measured_system_config`) instead of an assumed one.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.durable import durable_replace, fsync_dir
from ..core.efficiency import SystemConfig
from .serialization import load_pytree, save_pytree, tree_nbytes


@dataclass(frozen=True)
class CheckpointConfig:
    local_dir: str
    remote_dir: Optional[str] = None
    keep: int = 2
    async_drain: bool = True


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.local_dir, exist_ok=True)
        if cfg.remote_dir:
            os.makedirs(cfg.remote_dir, exist_ok=True)
        self._drain_thread: Optional[threading.Thread] = None
        #: wall seconds of each completed local-tier write (oldest first)
        self.save_seconds: List[float] = []

    # ------------------------------------------------------------------ save
    def _step_dir(self, root: str, step: int) -> str:
        return os.path.join(root, f"step_{step:010d}")

    def save(self, step: int, tree: Any, block: bool = False) -> str:
        """Write a checkpoint to the local tier; drain to remote async."""
        t0 = time.perf_counter()
        final = self._step_dir(self.cfg.local_dir, step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(tree, tmp)
        durable_replace(tmp, final)  # atomic + power-loss-durable commit
        self.save_seconds.append(time.perf_counter() - t0)
        self._gc(self.cfg.local_dir)
        if self.cfg.remote_dir:
            if self.cfg.async_drain and not block:
                self._wait_drain()
                self._drain_thread = threading.Thread(
                    target=self._drain, args=(step,), daemon=True
                )
                self._drain_thread.start()
            else:
                self._drain(step)
        return final

    def _drain(self, step: int) -> None:
        src = self._step_dir(self.cfg.local_dir, step)
        dst = self._step_dir(self.cfg.remote_dir, step)  # type: ignore[arg-type]
        tmp = dst + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        if not os.path.exists(src):
            return
        shutil.copytree(src, tmp)
        # durable_replace requires the tmp contents to be fsynced already;
        # copytree does not fsync, so flush the copied leaves + manifest
        # before committing the rename (else the remote tier could surface a
        # manifest pointing at torn leaf data after power loss)
        for name in os.listdir(tmp):
            fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fsync_dir(tmp)
        durable_replace(tmp, dst)
        self._gc(self.cfg.remote_dir)  # type: ignore[arg-type]

    def _wait_drain(self) -> None:
        if self._drain_thread is not None:
            self._drain_thread.join()
            self._drain_thread = None

    def _gc(self, root: str) -> None:
        steps = self.list_steps(root)
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self._step_dir(root, s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    @staticmethod
    def list_steps(root: str) -> List[int]:
        if not os.path.isdir(root):
            return []
        out = []
        for d in os.listdir(root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(root, d, "manifest.json")):
                    out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        local = self.list_steps(self.cfg.local_dir)
        remote = self.list_steps(self.cfg.remote_dir) if self.cfg.remote_dir else []
        allsteps = sorted(set(local) | set(remote))
        return allsteps[-1] if allsteps else None

    def restore(self, step: Optional[int] = None) -> Optional[Tuple[int, Any]]:
        """Newest (or given) checkpoint; local tier preferred."""
        self._wait_drain()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        for root in (self.cfg.local_dir, self.cfg.remote_dir):
            if not root:
                continue
            d = self._step_dir(root, step)
            if os.path.exists(os.path.join(d, "manifest.json")):
                return step, load_pytree(d)
        return None

    # ------------------------------------------------------------- measured
    def mean_save_seconds(self) -> float:
        """Mean measured local-tier write time (0.0 before the first save)."""
        if not self.save_seconds:
            return 0.0
        return sum(self.save_seconds) / len(self.save_seconds)

    def close(self) -> None:
        self._wait_drain()


# ----------------------------------------------------- measured SystemConfig
def measure_checkpoint_cost(
    tree: Any, repeats: int = 3
) -> Tuple[float, int]:
    """Measure the local-tier write cost of one checkpoint of ``tree``.

    Writes the tree ``repeats`` times to a throwaway directory through a
    :class:`CheckpointManager` (the same durable path production saves take)
    and returns ``(median seconds per write, checkpoint bytes)``.
    """
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    with tempfile.TemporaryDirectory(prefix="ckpt-measure-") as d:
        mgr = CheckpointManager(CheckpointConfig(local_dir=d, keep=1))
        for step in range(repeats):
            mgr.save(step, tree)
        mgr.close()
        secs = float(np.median(mgr.save_seconds))
    return secs, tree_nbytes(tree)


def system_config_from_measurement(
    seconds_per_write: float,
    checkpoint_bytes: int,
    mtbf: float,
    target_bytes: Optional[int] = None,
    **kwargs,
) -> SystemConfig:
    """Build a :class:`~repro_torch.core.efficiency.SystemConfig` whose ``t_chk``
    comes from a measured write, optionally extrapolated (at the measured
    throughput) to a deployment-scale checkpoint of ``target_bytes``.

    Pure function of its inputs — the measurement itself lives in
    :func:`measure_checkpoint_cost` so this part stays deterministic and
    testable.
    """
    if seconds_per_write <= 0.0 or checkpoint_bytes <= 0:
        raise ValueError("need a positive measured write time and size")
    t_chk = seconds_per_write
    if target_bytes is not None:
        t_chk = seconds_per_write * (float(target_bytes) / float(checkpoint_bytes))
    return SystemConfig(mtbf=mtbf, t_chk=t_chk, **kwargs)


def measured_system_config(
    tree: Any,
    mtbf: float,
    target_bytes: Optional[int] = None,
    repeats: int = 3,
    **kwargs,
) -> SystemConfig:
    """Measure ``tree``'s checkpoint write cost and build the corresponding
    :class:`~repro_torch.core.efficiency.SystemConfig` (paper §7's ``T_chk``,
    measured on this machine instead of assumed).

    ``target_bytes`` extrapolates the measured throughput to a deployment-
    scale checkpoint (CI-sized app states are kilobytes; a 100k-node
    system's coordinated checkpoint is not).
    """
    secs, nbytes = measure_checkpoint_cost(tree, repeats=repeats)
    return system_config_from_measurement(
        secs, nbytes, mtbf, target_bytes=target_bytes, **kwargs
    )
