# Port copy of repro/core/sysim.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Failure-trace system-efficiency simulator (paper §7, measured end-to-end).

The analytic model in :mod:`repro.core.efficiency` answers "what does
EasyCrash buy a running system?" with a first-order closed form and an
*assumed* recomputability.  This module answers it by *playing the tape*: a
seeded discrete-event simulation of a month- (or decade-) scale execution
under a failure trace, for four protection policies:

* ``"none"``        — no protection: a crash restarts the run from scratch;
* ``"checkpoint"``  — coordinated C/R at the Young/Daly interval
  (:func:`~repro.core.efficiency.young_interval`), crashes roll back to the
  last complete checkpoint;
* ``"easycrash"``   — EasyCrash only: a crash first attempts recomputation
  from the NVM image; if recomputation fails there is nothing to fall back
  to and the run restarts from scratch;
* ``"hybrid"``      — EasyCrash in front of C/R (the paper's deployment):
  recompute from NVM when the crash-campaign-measured outcome says so, fall
  back to the checkpoint otherwise.  The checkpoint interval stretches to
  ``young(T_chk, MTBF / (1 - success))`` because only non-recomputable
  crashes force rollbacks.

What makes this a *reproduction* rather than another Daly calculator is the
input: recovery success is drawn from the S1–S4 outcome fractions a real
crash campaign measured (:class:`RecomputeProfile`), and the cost of an
S2 recovery is drawn from the campaign's measured extra-recompute-iteration
histogram — the simulator consumes exactly what
:meth:`~repro.core.crash_tester.CrashTester.run_campaign` produces.

Failure interarrivals come from a :class:`FailureTrace` — exponential
(:class:`PoissonTrace`) or Weibull (:class:`WeibullTrace`, the standard HPC
failure-log fit with shape < 1 for infant mortality); traces scale to larger
machines via :func:`scaled_trace` (the paper's 100k -> 400k node scaling).
Failures keep arriving during recovery: a crash that strikes mid-restore
restarts the recovery (with a fresh outcome draw for the NVM policies).

Everything is seeded and single-threaded: the same
``(policy, system, trace, profile, seed)`` tuple reproduces the same
:class:`SimResult` bit for bit, regardless of environment.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .efficiency import SystemConfig, young_interval

OUTCOMES = ("S1", "S2", "S3", "S4")
POLICIES = ("none", "checkpoint", "easycrash", "hybrid")

SECONDS_PER_DAY = 24 * 3600.0
MONTH = 30 * SECONDS_PER_DAY


# ------------------------------------------------------------ failure traces
class FailureTrace:
    """A seeded stream of failure interarrival times (seconds)."""

    mtbf: float  # mean interarrival, seconds

    def interarrival(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def spec(self) -> Dict[str, object]:
        """JSON-round-trip-safe identity (for artifacts and frontier files)."""
        raise NotImplementedError


@dataclass(frozen=True)
class PoissonTrace(FailureTrace):
    """Exponential interarrivals — the analytic model's assumption."""

    mtbf: float

    def interarrival(self, rng: np.random.Generator) -> float:
        return float(rng.exponential(self.mtbf))

    def spec(self) -> Dict[str, object]:
        return {"trace": "poisson", "mtbf": float(self.mtbf)}


@dataclass(frozen=True)
class WeibullTrace(FailureTrace):
    """Weibull interarrivals with mean ``mtbf``.

    ``shape < 1`` reproduces the burstiness of real HPC failure logs (many
    short gaps, a heavy tail of long ones); ``shape = 1`` degenerates to
    :class:`PoissonTrace`.  The scale is derived so the mean stays ``mtbf``:
    ``scale = mtbf / gamma(1 + 1/shape)``.
    """

    mtbf: float
    shape: float = 0.7

    @property
    def scale(self) -> float:
        return self.mtbf / math.gamma(1.0 + 1.0 / self.shape)

    def interarrival(self, rng: np.random.Generator) -> float:
        return float(self.scale * rng.weibull(self.shape))

    def spec(self) -> Dict[str, object]:
        return {"trace": "weibull", "mtbf": float(self.mtbf), "shape": float(self.shape)}


def scaled_trace(trace: FailureTrace, base_nodes: int, nodes: int) -> FailureTrace:
    """The trace of a ``nodes``-node machine, given one measured at
    ``base_nodes`` (MTBF scales inversely with node count)."""
    from .efficiency import scale_mtbf

    return dataclasses.replace(trace, mtbf=scale_mtbf(trace.mtbf, base_nodes, nodes))


def trace_from_spec(spec: Mapping[str, object]) -> FailureTrace:
    """Rehydrate a :class:`FailureTrace` from its :meth:`~FailureTrace.spec`
    (the inverse used when frontier/fleet artifacts are read back)."""
    kind = spec.get("trace")
    if kind == "poisson":
        return PoissonTrace(mtbf=float(spec["mtbf"]))
    if kind == "weibull":
        return WeibullTrace(mtbf=float(spec["mtbf"]),
                            shape=float(spec.get("shape", 0.7)))
    raise ValueError(f"unknown trace spec {dict(spec)!r}")


# --------------------------------------------------------- recompute profile
@dataclass(frozen=True)
class RecomputeProfile:
    """Campaign-measured recovery behaviour of one (app, fault model) pair.

    ``fractions`` are the S1–S4 outcome fractions of a crash campaign
    (S1: recompute succeeds outright; S2: succeeds after extra iterations;
    S3/S4: recompute fails — interruption or budget exhaustion).
    ``extra_iters_hist`` is the measured histogram of extra recompute
    iterations over the campaign's S2 records, as sorted
    ``(extra_iters, count)`` pairs; the simulator draws S2 recompute costs
    from it.  ``golden_iters`` and ``n_records`` carry the measurement's
    provenance (how long the app runs, how many crash tests back the rates).
    """

    app_name: str
    fault_spec: Mapping[str, object]
    fractions: Mapping[str, float]
    extra_iters_hist: Tuple[Tuple[int, int], ...] = ()
    golden_iters: int = 0
    n_records: int = 0

    def __post_init__(self):
        unknown = set(self.fractions) - set(OUTCOMES)
        if unknown:
            raise ValueError(f"unknown outcome classes {sorted(unknown)}")
        total = sum(float(self.fractions.get(c, 0.0)) for c in OUTCOMES)
        if not math.isclose(total, 1.0, abs_tol=1e-6):
            raise ValueError(f"outcome fractions sum to {total}, expected 1")
        if any(float(v) < 0.0 for v in self.fractions.values()):
            raise ValueError("outcome fractions must be non-negative")

    # ------------------------------------------------------------- measures
    @property
    def recomputability(self) -> float:
        """The paper's R: fraction of crashes recomputed with no extra work."""
        return float(self.fractions.get("S1", 0.0))

    @property
    def success_rate(self) -> float:
        """Fraction of crashes the NVM image recovers at all (S1 + S2)."""
        return float(self.fractions.get("S1", 0.0)) + float(self.fractions.get("S2", 0.0))

    def mean_extra_iters(self) -> float:
        """Mean extra recompute iterations over the S2 histogram (0 if empty)."""
        total = sum(c for _, c in self.extra_iters_hist)
        if not total:
            return 0.0
        return sum(i * c for i, c in self.extra_iters_hist) / total

    # ---------------------------------------------------------------- draws
    def draw_outcome(self, rng: np.random.Generator) -> str:
        u = float(rng.random())
        acc = 0.0
        for c in OUTCOMES:
            acc += float(self.fractions.get(c, 0.0))
            if u < acc:
                return c
        return "S4"

    def draw_extra_iters(self, rng: np.random.Generator) -> int:
        if not self.extra_iters_hist:
            return 0
        total = sum(c for _, c in self.extra_iters_hist)
        u = float(rng.random()) * total
        acc = 0
        for iters, count in self.extra_iters_hist:
            acc += count
            if u < acc:
                return int(iters)
        return int(self.extra_iters_hist[-1][0])

    # --------------------------------------------------------- construction
    @staticmethod
    def from_campaign(campaign, fault=None) -> "RecomputeProfile":
        """Measure a profile from a finished
        :class:`~repro.core.crash_tester.CampaignResult`.

        ``fault`` is the :class:`~repro.core.faults.FaultModel` the campaign
        ran under (``None`` = the default clean power failure): campaign
        results do not carry their fault model, but a profile must — rates
        measured under torn writes are not rates under power failures.
        """
        if fault is None:
            from .faults import PowerFail

            fault = PowerFail()
        hist: Dict[int, int] = {}
        for r in campaign.records:
            if r.outcome == "S2":
                hist[int(r.extra_iters)] = hist.get(int(r.extra_iters), 0) + 1
        return RecomputeProfile(
            app_name=campaign.app_name,
            fault_spec=dict(fault.spec()),
            fractions=campaign.class_fractions(),
            extra_iters_hist=tuple(sorted(hist.items())),
            golden_iters=int(campaign.golden_iters),
            n_records=int(campaign.n),
        )

    @staticmethod
    def from_fractions(
        app_name: str,
        fractions: Mapping[str, float],
        fault_spec: Optional[Mapping[str, object]] = None,
        extra_iters_hist: Sequence[Tuple[int, int]] = (),
        golden_iters: int = 0,
        n_records: int = 0,
    ) -> "RecomputeProfile":
        """A synthetic profile (parity tests, smoke runs, what-if sweeps)."""
        full = {c: float(fractions.get(c, 0.0)) for c in OUTCOMES}
        return RecomputeProfile(
            app_name=app_name,
            fault_spec=dict(fault_spec or {"model": "synthetic"}),
            fractions=full,
            extra_iters_hist=tuple((int(i), int(c)) for i, c in extra_iters_hist),
            golden_iters=int(golden_iters),
            n_records=int(n_records),
        )


# --------------------------------------------------------------- sim result
@dataclass(frozen=True)
class SimResult:
    policy: str
    efficiency: float          # useful computation / total wall time
    useful_time: float
    total_time: float
    interval: float            # checkpoint interval used (0 for none/easycrash)
    n_failures: int
    n_checkpoints: int
    n_nvm_recoveries: int      # crashes recovered from the NVM image (S1/S2)
    n_fallbacks: int           # crashes rolled back to a checkpoint
    n_restarts: int            # crashes that restarted the run from scratch
    lost_work: float           # work wiped by rollbacks/restarts
    breakdown: Dict[str, float]  # wall time per phase bucket

    def spec(self) -> Dict[str, object]:
        """Strict-JSON dict of the full result (sorted breakdown)."""
        return {
            "policy": self.policy,
            "efficiency": float(self.efficiency),
            "useful_time": float(self.useful_time),
            "total_time": float(self.total_time),
            "interval": float(self.interval),
            "n_failures": int(self.n_failures),
            "n_checkpoints": int(self.n_checkpoints),
            "n_nvm_recoveries": int(self.n_nvm_recoveries),
            "n_fallbacks": int(self.n_fallbacks),
            "n_restarts": int(self.n_restarts),
            "lost_work": float(self.lost_work),
            "breakdown": {k: float(v) for k, v in sorted(self.breakdown.items())},
        }


class _Clock:
    """Wall clock + failure stream.  Advancing through a phase either
    completes it or stops at the next failure; the simulation ends the
    instant the failure budget or the horizon is reached (a budget-boundary
    failure is counted but not processed — at 10k events the truncation is
    far below the parity tolerance)."""

    def __init__(self, trace: FailureTrace, rng: np.random.Generator,
                 n_failures: Optional[int], horizon: Optional[float]):
        self.trace = trace
        self.rng = rng
        self.limit = n_failures  # None: horizon-only run, no failure budget
        self.horizon = horizon
        self.now = 0.0
        self.failures = 0
        self.next_fail = trace.interarrival(rng)
        self.done = False
        self.buckets: Dict[str, float] = {}

    def advance(self, duration: float, bucket: str) -> Tuple[float, bool]:
        """Advance up to ``duration`` seconds of ``bucket`` time.

        Returns ``(elapsed, failed)``; checks :attr:`done` after every call.
        """
        end = self.now + duration
        cut, event = end, None
        if self.next_fail < cut:
            cut, event = self.next_fail, "fail"
        if self.horizon is not None and self.horizon <= cut:
            cut, event = self.horizon, "horizon"
        elapsed = cut - self.now
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + elapsed
        self.now = cut
        if event == "horizon":
            self.done = True
            return elapsed, False
        if event == "fail":
            self.failures += 1
            if self.limit is not None and self.failures >= self.limit:
                self.done = True
            else:
                self.next_fail = self.now + self.trace.interarrival(self.rng)
            return elapsed, True
        return elapsed, False


class _SimState:
    """Mutable per-run counters (the frozen :class:`SimResult` is built from
    these at the end)."""

    def __init__(self):
        self.since_ckpt = 0.0   # live work not yet retained by a checkpoint
        self.committed = 0.0    # work safely behind a complete checkpoint
        self.lost = 0.0
        self.n_checkpoints = 0
        self.n_nvm = 0
        self.n_fallbacks = 0
        self.n_restarts = 0


def default_interval(policy: str, system: SystemConfig, trace: FailureTrace,
                     profile: Optional[RecomputeProfile] = None) -> float:
    """The policy's Young/Daly checkpoint interval.

    ``"hybrid"`` stretches the MTBF by ``1 / (1 - success_rate)``: only
    crashes the NVM image cannot recover force a rollback, so the effective
    failure rate the checkpoint scheme must absorb is that much lower.
    """
    if policy == "checkpoint":
        return young_interval(system.t_chk, trace.mtbf)
    if policy == "hybrid":
        if profile is None:
            raise ValueError("hybrid interval needs a RecomputeProfile")
        s = min(profile.success_rate, 0.999999)
        return young_interval(system.t_chk, trace.mtbf / (1.0 - s))
    return 0.0


def _handle_failure(policy: str, clock: _Clock, state: _SimState,
                    system: SystemConfig, profile: Optional[RecomputeProfile],
                    rng: np.random.Generator, t_iter: float) -> None:
    """Process one failure, and any failures that strike during its own
    recovery (each re-enters as a fresh failure with a fresh outcome draw)."""
    pending = True
    while pending and not clock.done:
        pending = False
        if policy == "checkpoint":
            state.n_fallbacks += 1
            state.lost += state.since_ckpt
            state.since_ckpt = 0.0
            phases = [(system.t_r, "restore"), (system.t_sync, "sync")]
        elif policy == "none":
            state.n_restarts += 1
            state.lost += state.since_ckpt
            state.since_ckpt = 0.0
            phases = [(system.t_sync, "sync")]
        else:  # easycrash / hybrid: try the NVM image first
            outcome = profile.draw_outcome(rng)
            if outcome in ("S1", "S2"):
                state.n_nvm += 1
                phases = [(system.nvm_restore_time, "nvm_restore")]
                if outcome == "S2":
                    extra = profile.draw_extra_iters(rng)
                    if extra:
                        phases.append((extra * t_iter, "recompute"))
                phases.append((system.t_sync, "sync"))
            elif policy == "hybrid":
                state.n_fallbacks += 1
                state.lost += state.since_ckpt
                state.since_ckpt = 0.0
                phases = [(system.t_r, "restore"), (system.t_sync, "sync")]
            else:
                state.n_restarts += 1
                state.lost += state.since_ckpt
                state.since_ckpt = 0.0
                phases = [(system.t_sync, "sync")]
        for dur, bucket in phases:
            _, failed = clock.advance(dur, bucket)
            if failed:
                pending = not clock.done  # recovery interrupted: handle anew
                break
            if clock.done:
                break


def simulate_policy(
    policy: str,
    system: SystemConfig,
    trace: FailureTrace,
    profile: Optional[RecomputeProfile] = None,
    *,
    n_failures: int = 10_000,
    horizon: Optional[float] = None,
    interval: Optional[float] = None,
    t_s: float = 0.03,
    t_iter: float = 1.0,
    seed: int = 0,
) -> SimResult:
    """Play one execution under a failure trace and score its efficiency.

    * ``n_failures`` — stop after this many failure events (the estimator's
      sample size); ``horizon`` — or after this much wall time, whichever
      comes first (e.g. :data:`MONTH`).
    * ``interval`` — checkpoint interval for the checkpointing policies;
      ``None`` uses :func:`default_interval` (Young at the policy's
      effective MTBF).
    * ``t_s`` — EasyCrash's flush-overhead fraction: useful work of the
      ``easycrash``/``hybrid`` policies is taxed by ``(1 - t_s)`` exactly as
      in :func:`~repro.core.efficiency.efficiency_with`.
    * ``t_iter`` — wall seconds one application iteration costs at
      deployment scale; converts the profile's measured extra-recompute-
      iteration draws (S2 recoveries) into downtime.

    Efficiency counts *retained* useful work: work behind a complete
    checkpoint, plus whatever is live when the tape ends (a crash-free
    shutdown keeps in-flight progress; without this boundary convention a
    near-perfect profile's stretched interval would misread end-of-horizon
    work as lost).  For ``easycrash``/``none`` the live progress since the
    last unrecovered crash is all there is.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (one of {POLICIES})")
    if policy in ("easycrash", "hybrid") and profile is None:
        raise ValueError(f"policy {policy!r} needs a RecomputeProfile")
    if n_failures < 1 and horizon is None:
        raise ValueError("need a failure budget or a horizon to terminate")
    if interval is not None and interval <= 0:
        raise ValueError("interval must be positive")

    checkpointing = policy in ("checkpoint", "hybrid")
    T = (interval if interval is not None
         else default_interval(policy, system, trace, profile))
    tax = t_s if policy in ("easycrash", "hybrid") else 0.0

    rng = np.random.default_rng(seed)
    clock = _Clock(trace, rng, n_failures if n_failures >= 1 else None, horizon)
    state = _SimState()

    while not clock.done:
        if checkpointing:
            elapsed, failed = clock.advance(T - state.since_ckpt, "work")
            state.since_ckpt += elapsed
            if clock.done:
                break
            if failed:
                _handle_failure(policy, clock, state, system, profile, rng, t_iter)
                continue
            _, failed = clock.advance(system.t_chk, "checkpoint")
            if clock.done:
                break
            if failed:
                # the torn checkpoint is discarded; the previous one stands
                _handle_failure(policy, clock, state, system, profile, rng, t_iter)
                continue
            state.committed += state.since_ckpt
            state.since_ckpt = 0.0
            state.n_checkpoints += 1
        else:
            # work straight through to the next failure (or the horizon)
            chunk = clock.next_fail - clock.now + 1.0
            elapsed, failed = clock.advance(chunk, "work")
            state.since_ckpt += elapsed
            if clock.done:
                break
            if failed:
                _handle_failure(policy, clock, state, system, profile, rng, t_iter)

    retained = state.committed + state.since_ckpt
    useful = retained * (1.0 - tax)
    total = clock.now
    return SimResult(
        policy=policy,
        efficiency=useful / total if total > 0 else 0.0,
        useful_time=useful,
        total_time=total,
        interval=T,
        n_failures=clock.failures,
        n_checkpoints=state.n_checkpoints,
        n_nvm_recoveries=state.n_nvm,
        n_fallbacks=state.n_fallbacks,
        n_restarts=state.n_restarts,
        lost_work=state.lost,
        breakdown=dict(clock.buckets),
    )


# --------------------------------------------------------- interval sweeps
@dataclass(frozen=True)
class IntervalPoint:
    interval: float
    efficiency: float


@dataclass(frozen=True)
class IntervalSweep:
    policy: str
    young: float                       # the Young/Daly anchor interval
    points: Tuple[IntervalPoint, ...]  # sorted by interval
    best: IntervalPoint


DEFAULT_SWEEP_FACTORS = (0.25, 0.4, 0.6, 0.8, 1.0, 1.25, 1.6, 2.0, 3.0)


def optimize_interval(
    policy: str,
    system: SystemConfig,
    trace: FailureTrace,
    profile: Optional[RecomputeProfile] = None,
    *,
    factors: Sequence[float] = DEFAULT_SWEEP_FACTORS,
    n_failures: int = 2_000,
    t_s: float = 0.03,
    t_iter: float = 1.0,
    seed: int = 0,
) -> IntervalSweep:
    """Sweep checkpoint intervals around the Young anchor and report the
    simulated optimum.

    Young's formula is first-order — it ignores work lost to crashes during
    checkpoint writes and the recovery costs themselves — so on harsh
    configurations (large ``t_chk`` relative to MTBF) the simulated optimum
    sits *below* the anchor.  Every interval is simulated with the same
    seed, so the sweep compares policies on identical failure traces.
    """
    if policy not in ("checkpoint", "hybrid"):
        raise ValueError(f"policy {policy!r} takes no checkpoint interval")
    anchor = default_interval(policy, system, trace, profile)
    points = []
    for f in sorted(set(float(x) for x in factors)):
        r = simulate_policy(
            policy, system, trace, profile, n_failures=n_failures,
            interval=anchor * f, t_s=t_s, t_iter=t_iter, seed=seed,
        )
        points.append(IntervalPoint(interval=anchor * f, efficiency=r.efficiency))
    best = max(points, key=lambda p: p.efficiency)
    return IntervalSweep(policy=policy, young=anchor,
                         points=tuple(points), best=best)


def efficiency_frontier(
    system: SystemConfig,
    trace: FailureTrace,
    profile: RecomputeProfile,
    *,
    policies: Sequence[str] = POLICIES,
    factors: Sequence[float] = DEFAULT_SWEEP_FACTORS,
    n_failures: int = 2_000,
    t_s: float = 0.03,
    t_iter: float = 1.0,
    seed: int = 0,
) -> Dict[str, object]:
    """Per-policy efficiency (with interval sweeps where applicable), as one
    JSON-serializable document — the artifact the scheduled CI job uploads
    next to the robustness matrix."""
    doc: Dict[str, object] = {
        "app": profile.app_name,
        "fault": dict(profile.fault_spec),
        "profile": {
            "fractions": {c: float(profile.fractions.get(c, 0.0)) for c in OUTCOMES},
            "success_rate": profile.success_rate,
            "mean_extra_iters": profile.mean_extra_iters(),
            "n_records": profile.n_records,
        },
        "system": {
            "mtbf": float(system.mtbf),
            "t_chk": float(system.t_chk),
            "t_sync": float(system.t_sync),
            "t_r": float(system.t_r),
            "nvm_restore_time": float(system.nvm_restore_time),
        },
        "trace": trace.spec(),
        "t_s": float(t_s),
        "t_iter": float(t_iter),
        "n_failures": int(n_failures),
        "seed": int(seed),
        "policies": {},
    }
    pols: Dict[str, object] = doc["policies"]  # type: ignore[assignment]
    for policy in policies:
        if policy in ("checkpoint", "hybrid"):
            sweep = optimize_interval(
                policy, system, trace, profile, factors=factors,
                n_failures=n_failures, t_s=t_s, t_iter=t_iter, seed=seed,
            )
            pols[policy] = {
                "young_interval": sweep.young,
                "sweep": [
                    {"interval": p.interval, "efficiency": p.efficiency}
                    for p in sweep.points
                ],
                "best": {"interval": sweep.best.interval,
                         "efficiency": sweep.best.efficiency},
            }
        else:
            r = simulate_policy(
                policy, system, trace, profile, n_failures=n_failures,
                t_s=t_s, t_iter=t_iter, seed=seed,
            )
            pols[policy] = {"efficiency": r.efficiency}
    return doc


__all__ = [
    "MONTH",
    "OUTCOMES",
    "POLICIES",
    "DEFAULT_SWEEP_FACTORS",
    "FailureTrace",
    "PoissonTrace",
    "WeibullTrace",
    "scaled_trace",
    "trace_from_spec",
    "RecomputeProfile",
    "SimResult",
    "IntervalPoint",
    "IntervalSweep",
    "default_interval",
    "simulate_policy",
    "optimize_interval",
    "efficiency_frontier",
]
