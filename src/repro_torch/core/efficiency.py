# Port copy of repro/core/efficiency.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""System-efficiency model for large-scale C/R with and without EasyCrash.

Implements paper §7 (Eqs. 6–9): synchronous coordinated checkpointing at the
Young-formula interval, crashes at Poisson rate 1/MTBF, and — with EasyCrash —
a split of crashes into M'' (recompute from the NVM image, cheap) and
M' (fall back to the last checkpoint).  Efficiency is useful computation time
over total wall time.  ``tau_threshold`` inverts the model to the minimum
recomputability at which EasyCrash beats plain C/R (the Eq. 4 threshold).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

SECONDS_PER_HOUR = 3600.0
TEN_YEARS = 10 * 365.25 * 24 * SECONDS_PER_HOUR


def young_interval(t_chk: float, mtbf: float) -> float:
    """Young's first-order optimal checkpoint interval."""
    return math.sqrt(2.0 * t_chk * mtbf)


def expected_overhead(interval: float, t_chk: float, mtbf: float) -> float:
    """The first-order overhead rate Young's interval minimizes: checkpoint
    cost amortized over the interval plus expected rework per crash,
    ``t_chk/T + T/(2*MTBF)``.  Exactly minimized at :func:`young_interval`;
    the *full* bookkeeping model (and the discrete-event simulator in
    :mod:`repro.core.sysim`) have their optimum slightly below it, because
    Young ignores crashes during checkpoint writes and recovery time."""
    return t_chk / interval + interval / (2.0 * mtbf)


@dataclass(frozen=True)
class SystemConfig:
    mtbf: float                      # seconds, whole-system MTBF
    t_chk: float                     # checkpoint write time (local tier)
    total_time: float = TEN_YEARS    # simulated wall time
    t_sync_frac: float = 0.5         # T_sync = frac * T_chk (paper's constant)
    nvm_restore_time: float = 30.0   # T_r': load data objects from local NVM

    @property
    def t_sync(self) -> float:
        return self.t_sync_frac * self.t_chk

    @property
    def t_r(self) -> float:
        return self.t_chk  # T_r = T_chk (paper assumption, after [7])

    def spec(self) -> Dict[str, object]:
        return {
            "mtbf": float(self.mtbf),
            "t_chk": float(self.t_chk),
            "total_time": float(self.total_time),
            "t_sync_frac": float(self.t_sync_frac),
            "nvm_restore_time": float(self.nvm_restore_time),
        }


@dataclass(frozen=True)
class EfficiencyResult:
    efficiency: float
    n_checkpoints: float
    n_crashes: float
    interval: float
    useful_time: float
    breakdown: Dict[str, float]


def efficiency_without(
    cfg: SystemConfig, interval: Optional[float] = None
) -> EfficiencyResult:
    """Eq. 6/7: plain C/R.  ``interval`` overrides the Young checkpoint
    interval (interval-sweep experiments); ``None`` is the paper's choice."""
    T = young_interval(cfg.t_chk, cfg.mtbf) if interval is None else float(interval)
    M = cfg.total_time / cfg.mtbf
    t_vain = 0.5 * T
    recovery = M * (t_vain + cfg.t_r + cfg.t_sync)
    # Total = N*(T + T_chk) + recovery  =>  N
    N = max(0.0, (cfg.total_time - recovery) / (T + cfg.t_chk))
    useful = N * T
    return EfficiencyResult(
        efficiency=useful / cfg.total_time,
        n_checkpoints=N,
        n_crashes=M,
        interval=T,
        useful_time=useful,
        breakdown={
            "checkpoint": N * cfg.t_chk,
            "recovery": recovery,
            "useful": useful,
        },
    )


def efficiency_with(
    cfg: SystemConfig,
    recomputability: float,
    t_s: float = 0.03,
    interval: Optional[float] = None,
) -> EfficiencyResult:
    """Eq. 8/9: EasyCrash in front of C/R.

    ``recomputability`` is R_EasyCrash; the crash stream splits into
    M'' = M*R (NVM restart, cost T_r' + T_sync) and M' = M*(1-R)
    (checkpoint rollback).  The checkpoint interval stretches via
    MTBF' = MTBF / (1 - R) — only non-recomputable crashes force rollbacks.
    EasyCrash's own flush overhead taxes useful time by (1 - t_s).
    ``interval`` overrides the stretched Young interval.
    """
    R = min(max(recomputability, 0.0), 0.999999)
    mtbf_ec = cfg.mtbf / (1.0 - R)
    T = young_interval(cfg.t_chk, mtbf_ec) if interval is None else float(interval)
    M = cfg.total_time / cfg.mtbf
    M_fallback = M * (1.0 - R)
    M_recompute = M * R
    t_vain = 0.5 * T
    recovery = (
        M_fallback * (t_vain + cfg.t_r + cfg.t_sync)
        + M_recompute * (cfg.nvm_restore_time + cfg.t_sync)
    )
    N = max(0.0, (cfg.total_time - recovery) / (T + cfg.t_chk))
    useful = N * T * (1.0 - t_s)
    return EfficiencyResult(
        efficiency=useful / cfg.total_time,
        n_checkpoints=N,
        n_crashes=M,
        interval=T,
        useful_time=useful,
        breakdown={
            "checkpoint": N * cfg.t_chk,
            "recovery_fallback": M_fallback * (t_vain + cfg.t_r + cfg.t_sync),
            "recovery_easycrash": M_recompute * (cfg.nvm_restore_time + cfg.t_sync),
            "flush_overhead": N * T * t_s,
            "useful": useful,
        },
    )


def tau_threshold(cfg: SystemConfig, t_s: float = 0.03, tol: float = 1e-5) -> float:
    """Minimum recomputability for which EasyCrash beats plain C/R (Eq. 4)."""
    base = efficiency_without(cfg).efficiency
    lo, hi = 0.0, 1.0
    if efficiency_with(cfg, hi, t_s).efficiency <= base:
        return float("inf")  # EasyCrash can never win under these parameters
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if efficiency_with(cfg, mid, t_s).efficiency > base:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return hi


def scale_mtbf(base_mtbf: float, base_nodes: int, nodes: int) -> float:
    """MTBF scales inversely with node count (paper's 100k→400k scaling)."""
    return base_mtbf * base_nodes / nodes


#: Optane-class sustained NVM write bandwidth, bytes/s (paper's device tier).
DEFAULT_NVM_WRITE_BW = 2e9


def persist_overhead_fraction(
    bytes_per_flush: float,
    flush_interval_s: float,
    nvm_write_bw: float = DEFAULT_NVM_WRITE_BW,
) -> float:
    """Measured ``t_s``: fraction of wall time spent writing flush traffic.

    Turns the *measured* delta-flush write volume (``ManagerStats.bytes_written``
    per flush, which delta mode shrinks to the changed blocks only) into the
    EasyCrash overhead knob that :func:`efficiency_with` taxes useful time by.
    Clamped to 1.0 — a flush that cannot keep up with the interval saturates.
    """
    if flush_interval_s <= 0:
        raise ValueError("flush_interval_s must be positive")
    if nvm_write_bw <= 0:
        raise ValueError("nvm_write_bw must be positive")
    return min(1.0, (float(bytes_per_flush) / nvm_write_bw) / flush_interval_s)
