# Port copy of repro/core/selection.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Critical data-object and code-region selection (paper §5).

Data objects: Spearman rank correlation between per-object data-inconsistency
rate and recompute success across a crash campaign.  An object is *critical*
iff R_s < 0 (more inconsistency => less recomputable) and p < 0.01.

Code regions: a multiple-choice 0/1 knapsack.  For each region k and flush
frequency x, the item has weight l_k / x (persistence overhead) and value
a_k * (c_k^x - c_k), with the Eq. 5 interpolation
``c_k^x = (c_k^max - c_k)/x + c_k``.  The DP maximises recomputability gain
under the runtime budget t_s, and the result is checked against the system
efficiency threshold tau (Eq. 4).

No scipy on the box: Spearman's p-value uses the exact t-distribution via a
regularised-incomplete-beta continued fraction (Numerical Recipes 6.4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------- stats

def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean rank), 1-based."""
    x = np.asarray(x, dtype=float)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(x.size, dtype=float)
    sx = x[order]
    i = 0
    while i < x.size:
        j = i
        while j + 1 < x.size and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta function."""
    MAXIT, EPS, FPMIN = 200, 3e-14, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < EPS:
            break
    return h


def _betainc_reg(a: float, b: float, x: float) -> float:
    """Regularised incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (
        math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        + a * math.log(x) + b * math.log1p(-x)
    )
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def t_sf(t: float, df: float) -> float:
    """Student-t survival function P(T > t)."""
    x = df / (df + t * t)
    p = 0.5 * _betainc_reg(df / 2.0, 0.5, x)
    return p if t >= 0 else 1.0 - p


def spearman(x: Sequence[float], y: Sequence[float]) -> Tuple[float, float]:
    """Spearman's rank correlation R_s and two-sided p-value.

    Returns (nan, 1.0) for degenerate inputs (constant vectors / n < 4).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    n = x.size
    if n != y.size:
        raise ValueError("length mismatch")
    if n < 4 or np.all(x == x[0]) or np.all(y == y[0]):
        return float("nan"), 1.0
    rx, ry = _rankdata(x), _rankdata(y)
    rx = rx - rx.mean()
    ry = ry - ry.mean()
    denom = math.sqrt(float(rx @ rx) * float(ry @ ry))
    if denom == 0.0:
        return float("nan"), 1.0
    rs = float(rx @ ry) / denom
    rs = max(-1.0, min(1.0, rs))
    if abs(rs) >= 1.0:
        return rs, 0.0
    t = rs * math.sqrt((n - 2) / (1.0 - rs * rs))
    p = 2.0 * t_sf(abs(t), n - 2)
    return rs, min(1.0, p)


# ---------------------------------------------------------- object selection
# Result/value dataclasses in core/ are frozen: several (CacheConfig,
# PersistPlan) appear as shared default parameter values, and the rest are
# outputs whose silent in-place mutation would desynchronise stores,
# fingerprints and artifacts.  Mutable-by-design counters (WriteStats,
# ManagerStats) stay unfrozen.
@dataclass(frozen=True)
class ObjectScore:
    name: str
    rs: float
    p_value: float
    critical: bool


def select_objects(
    campaign,
    candidates: Sequence[str],
    p_threshold: float = 0.01,
) -> List[ObjectScore]:
    """Paper §5.1: critical objects have R_s < 0 with p below threshold."""
    scores = []
    for obj in candidates:
        x, y = campaign.vectors_for_selection(obj)
        rs, p = spearman(x, y)
        critical = (not math.isnan(rs)) and rs < 0.0 and p < p_threshold
        scores.append(ObjectScore(obj, rs, p, critical))
    return scores


def critical_objects(scores: Sequence[ObjectScore]) -> Tuple[str, ...]:
    return tuple(s.name for s in scores if s.critical)


# ---------------------------------------------------------- region selection
@dataclass(frozen=True)
class RegionChoice:
    region_idx: int
    freq: int            # flush every `freq` iterations
    gain: float          # a_k * (c_k^x - c_k)
    overhead: float      # l_k / freq


@dataclass(frozen=True)
class RegionSelection:
    choices: List[RegionChoice]
    expected_recomputability: float   # Y' of Eq. 2
    total_overhead: float
    meets_tau: bool

    def plan_freqs(self) -> Dict[int, int]:
        return {c.region_idx: c.freq for c in self.choices}


def interpolate_ckx(c_max: float, c_base: float, x: int) -> float:
    """Eq. 5 linear interpolation between every-iteration and never."""
    return (c_max - c_base) / x + c_base


def select_regions_from_gains(
    gains: Mapping[int, float],
    overheads: Mapping[int, float],
    y_base: float,
    t_s: float,
    tau: float,
    freq_options: Sequence[int] = (1, 2, 4, 8),
    resolution: int = 2000,
) -> RegionSelection:
    """Multiple-choice knapsack core.

    ``gains[k]``: recomputability gain of flushing at region k every
    iteration (x = 1); frequency x scales the gain by 1/x (Eq. 5) and the
    overhead ``overheads[k]`` by 1/x.  Budget t_s; target tau (Eq. 3/4).
    """
    region_ids = sorted(gains.keys())
    W = len(region_ids)
    scale = resolution / max(t_s, 1e-12)

    def wt(ov: float) -> int:
        return int(math.ceil(ov * scale - 1e-9))

    NEG = -1.0
    dp = [0.0] + [NEG] * resolution
    choice: List[List[Optional[Tuple[int, int]]]] = [
        [None] * (resolution + 1) for _ in range(W)
    ]
    for ki, k in enumerate(region_ids):
        new_dp = dp[:]  # "skip region k" keeps previous
        for x in freq_options:
            gain = gains[k] / x
            if gain <= 0:
                continue
            w = wt(overheads[k] / x)
            if w > resolution:
                continue
            for j in range(resolution, w - 1, -1):
                if dp[j - w] >= 0.0 and dp[j - w] + gain > new_dp[j]:
                    new_dp[j] = dp[j - w] + gain
                    choice[ki][j] = (x, j - w)
        dp = new_dp

    j_best = max(range(resolution + 1), key=lambda j: dp[j])
    choices: List[RegionChoice] = []
    j = j_best
    for ki in range(W - 1, -1, -1):
        ch = choice[ki][j]
        if ch is not None:
            x, j_prev = ch
            k = region_ids[ki]
            choices.append(RegionChoice(k, x, gains[k] / x, overheads[k] / x))
            j = j_prev
    choices.reverse()

    y_prime = y_base + sum(c.gain for c in choices)
    total_overhead = sum(c.overhead for c in choices)
    return RegionSelection(
        choices=choices,
        expected_recomputability=y_prime,
        total_overhead=total_overhead,
        meets_tau=y_prime > tau,
    )


def select_regions(
    a: Sequence[float],
    c_base: Sequence[float],
    c_max: Sequence[float],
    l: Sequence[float],
    t_s: float,
    tau: float,
    freq_options: Sequence[int] = (1, 2, 4, 8),
    resolution: int = 2000,
) -> RegionSelection:
    """Paper-faithful wrapper: per-region gains a_k * (c_k^max - c_k) from a
    single persist-everywhere campaign (§5.2's shortcut)."""
    W = len(a)
    if not (len(c_base) == len(c_max) == len(l) == W):
        raise ValueError("length mismatch")
    gains = {k: a[k] * (c_max[k] - c_base[k]) for k in range(W)}
    overheads = {k: l[k] for k in range(W)}
    y_base = float(sum(ak * ck for ak, ck in zip(a, c_base)))
    return select_regions_from_gains(
        gains, overheads, y_base, t_s, tau, freq_options, resolution
    )
