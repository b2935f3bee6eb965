# Port copy of repro/core/adaptive.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Adaptive crash campaigns: sequential early stopping + importance sampling.

The W+2 workflow (paper §5.3) brute-forces every pre-drawn crash point of
every per-region campaign even when the downstream decision — the knapsack's
region/frequency selection in :mod:`repro.core.selection` — was already
determined by the first handful of outcomes.  This module supplies the two
halves of the sample-efficient replacement:

* **Batch-sequential early stopping.**  Region campaigns execute in
  deterministic *rounds* (whole crash-window shards, in planned-test order).
  After each round, every campaigned region gets an interval on its final S1
  rate — the intersection of a Wilson score interval with the *hard reachable
  bound* (remaining tests are pre-drawn, so the final self-normalized
  estimate is bracketed by "every remaining test fails" / "every remaining
  test passes").  The campaigns stop as soon as the knapsack decision is
  invariant over the whole gain box (:func:`selection_invariant`).  Because
  the round partition and the stopping check are pure functions of the
  completed-round prefix, worker count and kill/resume cannot change the
  executed set — bit-for-bit.

* **Static-prior importance sampling.**  :class:`StaticPriorSampler` biases
  the per-test crash-*region* draw toward regions whose static-plan
  confidence (PR 8's jaxpr dataflow walk) is low, carrying the likelihood
  ratio in :attr:`~repro.core.crash_tester.PlannedTest.weight`.  The
  self-normalized estimator (:func:`weighted_outcome_stats`) recovers
  unbiased S1–S4 rates; with uniform weights it degrades exactly to the
  empirical fractions.

Soundness of the stop rule: the knapsack objective is linear in the gain
vector for any fixed choice set, so over a box of gains the optimal choice
is corner-determined — if every corner (and the point estimate) yields the
same ``plan_freqs()``, so does every interior point.  When the interval is
the hard reachable bound alone, a fired stop is therefore a *theorem*: the
truncated campaign's final plan equals the full campaign's.  The Wilson
intersection trades that certainty for earlier stopping at the interval's
coverage level; ``tests/test_adaptive.py`` pins the resulting plans against
the brute-force workflow on the whole suite.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .crash_tester import PlannedTest
from .selection import select_regions_from_gains


# ------------------------------------------------------------------ estimator
def wilson_interval(successes: float, n: float, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for a Bernoulli rate.

    Accepts *effective* (possibly fractional) counts so weighted campaigns
    can reuse it with the Kish sample size.  ``n <= 0`` returns the vacuous
    ``(0, 1)`` — no evidence constrains nothing.
    """
    if n <= 0:
        return 0.0, 1.0
    p = min(1.0, max(0.0, successes / n))
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return max(0.0, center - half), min(1.0, center + half)


def effective_sample_size(weights: Sequence[float]) -> float:
    """Kish effective n: ``(sum w)^2 / sum w^2`` (== len for uniform weights)."""
    w = np.asarray(weights, dtype=float)
    if w.size == 0:
        return 0.0
    s2 = float(np.sum(w * w))
    if s2 <= 0.0:
        return 0.0
    return float(np.sum(w)) ** 2 / s2


def weighted_outcome_stats(
    values: Sequence[float], weights: Sequence[float]
) -> Tuple[float, float]:
    """Self-normalized IS estimate of a rate: ``(sum w*x / sum w, n_eff)``.

    ``values`` are 0/1 outcome indicators; with uniform weights the estimate
    is the plain empirical fraction and ``n_eff == len(values)``.
    """
    w = np.asarray(weights, dtype=float)
    x = np.asarray(values, dtype=float)
    tot = float(np.sum(w))
    if tot <= 0.0:
        return float("nan"), 0.0
    return float(np.sum(w * x)) / tot, effective_sample_size(w)


# --------------------------------------------------------------------- config
@dataclass(frozen=True)
class SequentialConfig:
    """Knobs of the adaptive scheduler, one frozen object.

    ``round_tests`` sets the per-campaign round size: whole crash-window
    shards accumulate (in planned-test order) until a round holds at least
    this many tests, so rounds align with the store's shard durability
    granularity.  ``z`` is the Wilson interval's critical value.  The default
    1.645 is the one-sided 95% point: every comparison the stopping rule
    makes is directional (is this gain still positive?  still below the
    budget cut?), and the interval is always intersected with the hard
    reachable bound, so a huge ``z`` degrades to the provably-safe rule
    rather than to "never stop".  ``sampler_bias`` scales the
    importance-sampling tilt toward
    low-confidence regions (0 disables IS: uniform draws, unit weights).
    ``max_corners`` caps the invariance sweep — above it the round never
    claims invariance (no silent unsoundness on very wide apps).

    Equivalence fine print: early stopping alone is *provably* decision-
    invariant (the plan equals what full execution of the same campaigns
    would produce).  ``sampler_bias=0`` additionally makes the draws
    bit-identical to the brute-force workflow's, so the final plan provably
    equals brute force.  With bias > 0 the IS estimator is unbiased for the
    same rates but sees different finite-sample draws, so a knife-edge
    knapsack decision (per-region gains within sampling noise of a budget or
    sign boundary) can resolve differently; the differential suite pins the
    per-app agreement at the defaults.
    """

    z: float = 1.645
    round_tests: int = 4
    min_rounds: int = 1
    sampler_bias: float = 1.0
    max_corners: int = 4096

    def __post_init__(self):
        if self.round_tests < 1:
            raise ValueError(f"round_tests must be >= 1, got {self.round_tests}")
        if self.min_rounds < 1:
            raise ValueError(f"min_rounds must be >= 1, got {self.min_rounds}")
        if self.z <= 0:
            raise ValueError(f"z must be > 0, got {self.z}")
        if self.sampler_bias < 0:
            raise ValueError(f"sampler_bias must be >= 0, got {self.sampler_bias}")

    def spec(self) -> Dict[str, object]:
        """JSON-round-trip-safe identity (store fingerprints, artifacts)."""
        return {
            "z": float(self.z),
            "round_tests": int(self.round_tests),
            "min_rounds": int(self.min_rounds),
            "sampler_bias": float(self.sampler_bias),
            "max_corners": int(self.max_corners),
        }


# -------------------------------------------------------------------- sampler
@dataclass(frozen=True)
class StaticPriorSampler:
    """Importance sampler over crash points, tilted by static-plan confidence.

    The historical draw is (uniform crash iteration, uniform time in the
    window) — the time draw makes the crash *region* proportional to its
    span length.  This sampler keeps the iteration draw and reweights the
    region draw:  ``q_k ∝ span_k * (1 + bias * (1 - confidence_k))`` — a
    region the static analysis is sure about keeps roughly its uniform mass,
    an uncertain one gets up to ``1 + bias`` times more.  Each test carries
    ``weight = p_k / q_k`` (uniform over proposal likelihood ratio) so the
    self-normalized estimator stays unbiased for the uniform-draw rates.

    ``confidences`` is indexed by region (from
    :meth:`repro.analysis.classify.StaticPlan.window_confidences`), rounded
    to 6 decimals so the sampler spec — and every store fingerprint built
    from it — is stable across float formatting.
    """

    confidences: Tuple[float, ...]
    bias: float = 3.0

    def __post_init__(self):
        object.__setattr__(
            self,
            "confidences",
            tuple(round(min(1.0, max(0.0, float(c))), 6) for c in self.confidences),
        )
        if self.bias < 0:
            raise ValueError(f"bias must be >= 0, got {self.bias}")

    def spec(self) -> Dict[str, object]:
        return {
            "kind": "static-prior",
            "bias": round(float(self.bias), 6),
            "confidences": [float(c) for c in self.confidences],
        }

    def _distributions(self, planner) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
        """(uniform p, proposal q, spans) over this planner's regions."""
        spans = planner.region_time_spans()
        if len(spans) != len(self.confidences):
            raise ValueError(
                f"sampler has {len(self.confidences)} region confidences but "
                f"{planner.app.name} has {len(spans)} regions"
            )
        lengths = np.array([max(0, t1 - t0) for t0, t1 in spans], dtype=float)
        if lengths.sum() <= 0:
            raise ValueError(f"{planner.app.name}: no positive region spans")
        p = lengths / lengths.sum()
        tilt = lengths * (1.0 + self.bias * (1.0 - np.asarray(self.confidences)))
        q = tilt / tilt.sum()
        return p, q, spans

    def draw(self, rng: np.random.Generator, planner) -> Tuple[int, int, float]:
        """One importance-sampled ``(crash_iter, crash_t, weight)``.

        Draw order is fixed (iteration, region, time-in-region) so a planned
        campaign is a pure function of the seed, exactly like the uniform
        planner.
        """
        p, q, spans = self._distributions(planner)
        crash_iter = int(rng.integers(0, planner.golden_iters))
        k = int(rng.choice(len(spans), p=q))
        t0, t1 = spans[k]
        t_lo, _ = planner.window_bounds(crash_iter)
        crash_t = t_lo + t0 + int(rng.integers(0, max(1, t1 - t0)))
        return crash_iter, crash_t, float(p[k] / q[k])


# ---------------------------------------------------------- decision analysis
def selection_invariant(
    point_gains: Mapping[int, float],
    gain_boxes: Mapping[int, Tuple[float, float]],
    overheads: Mapping[int, float],
    y_base: float,
    t_s: float,
    tau: float,
    freq_options: Sequence[int] = (1, 2, 4, 8),
    max_corners: int = 4096,
) -> Optional[Dict[int, int]]:
    """The knapsack's ``plan_freqs()`` if it is invariant over the gain box.

    ``point_gains`` holds every region's current point estimate;
    ``gain_boxes`` the (lo, hi) interval of each still-uncertain region
    (regions absent from it are held fixed at their point gain).  For a
    fixed choice set the knapsack objective is linear in the gain vector, so
    its optimum over a box is attained at a corner: if the DP returns the
    same plan at *every* corner and at the point estimate, the decision is
    settled — return it.  Any disagreement (or more than ``max_corners``
    corners) returns ``None``: keep sampling.
    """
    varying = sorted(k for k, (lo, hi) in gain_boxes.items() if hi - lo > 1e-12)
    if len(varying) > 0 and 2 ** len(varying) > max_corners:
        return None

    def decide(gains: Mapping[int, float]) -> Dict[int, int]:
        return select_regions_from_gains(
            gains, overheads, y_base, t_s=t_s, tau=tau, freq_options=freq_options
        ).plan_freqs()

    base = dict(point_gains)
    for k, (lo, hi) in gain_boxes.items():
        if k not in varying:
            base[k] = lo  # degenerate box: pin to its single value
    decision = decide(base)
    for corner in itertools.product(*[(gain_boxes[k][0], gain_boxes[k][1]) for k in varying]):
        gains = dict(base)
        gains.update(zip(varying, corner))
        if decide(gains) != decision:
            return None
    return decision


# --------------------------------------------------------------------- report
@dataclass(frozen=True)
class RegionEvidence:
    """Per-region adaptive evidence at the stop point."""

    region: int
    executed: int
    planned: int
    rate: float                    # self-normalized S1 estimate
    interval: Tuple[float, float]  # final-rate interval the stop was taken on
    n_eff: float

    def to_payload(self) -> Dict[str, object]:
        def _f(x: float):
            x = float(x)
            return None if x != x else round(x, 9)

        return {
            "region": int(self.region),
            "executed": int(self.executed),
            "planned": int(self.planned),
            "rate": _f(self.rate),
            "interval": [_f(self.interval[0]), _f(self.interval[1])],
            "n_eff": _f(self.n_eff),
        }

    @classmethod
    def from_payload(cls, d: Mapping[str, object]) -> "RegionEvidence":
        nan = float("nan")

        def _f(x):
            return nan if x is None else float(x)

        lo, hi = d["interval"]
        return cls(
            region=int(d["region"]), executed=int(d["executed"]),
            planned=int(d["planned"]), rate=_f(d["rate"]),
            interval=(_f(lo), _f(hi)), n_eff=_f(d["n_eff"]),
        )


@dataclass(frozen=True)
class AdaptiveReport:
    """What the adaptive scheduler did: the stopping decision and its evidence.

    Saved into workflow artifacts (only when the workflow actually ran
    adaptively, so historical artifact fingerprints are untouched).
    """

    rounds_executed: int
    rounds_total: int
    stopped_early: bool
    tests_executed: int            # sequential-campaign tests actually run
    tests_planned: int             # sequential-campaign tests brute force runs
    regions: Tuple[RegionEvidence, ...]
    stopping: Dict[str, object]    # SequentialConfig.spec()
    sampler: Optional[Dict[str, object]]  # StaticPriorSampler.spec() or None
    # evidence for the persist-everything reference campaign when it rode the
    # rounds (pure adaptive mode; ``region`` is -1).  None when the reference
    # ran in full (static+verify composition, where fixed gains consume it).
    reference: Optional[RegionEvidence] = None

    @property
    def tests_skipped(self) -> int:
        return self.tests_planned - self.tests_executed

    def to_payload(self) -> Dict[str, object]:
        return {
            "rounds_executed": int(self.rounds_executed),
            "rounds_total": int(self.rounds_total),
            "stopped_early": bool(self.stopped_early),
            "tests_executed": int(self.tests_executed),
            "tests_planned": int(self.tests_planned),
            "regions": [r.to_payload() for r in self.regions],
            "stopping": dict(self.stopping),
            "sampler": None if self.sampler is None else dict(self.sampler),
            **(
                {"reference": self.reference.to_payload()}
                if self.reference is not None else {}
            ),
        }

    @classmethod
    def from_payload(cls, d: Mapping[str, object]) -> "AdaptiveReport":
        return cls(
            rounds_executed=int(d["rounds_executed"]),
            rounds_total=int(d["rounds_total"]),
            stopped_early=bool(d["stopped_early"]),
            tests_executed=int(d["tests_executed"]),
            tests_planned=int(d["tests_planned"]),
            regions=tuple(RegionEvidence.from_payload(r) for r in d["regions"]),
            stopping=dict(d["stopping"]),
            sampler=None if d.get("sampler") is None else dict(d["sampler"]),
            reference=(
                None if d.get("reference") is None
                else RegionEvidence.from_payload(d["reference"])
            ),
        )


# ------------------------------------------------------------- round geometry
def shard_rounds(
    tests: Sequence[PlannedTest],
    shards: Mapping[int, Sequence[PlannedTest]],
    round_tests: int,
) -> List[List[int]]:
    """Partition one campaign's shards into deterministic rounds.

    Whole shards (never split — a shard is the store's durability unit), in
    order of each shard's first appearance in the planned-test sequence,
    greedily packed until a round holds at least ``round_tests`` tests.  A
    pure function of the plan, so every worker count and every resume
    computes the identical partition.
    """
    order: List[int] = []
    seen = set()
    for t in tests:
        if t.crash_iter not in seen:
            seen.add(t.crash_iter)
            order.append(t.crash_iter)
    rounds: List[List[int]] = []
    current: List[int] = []
    count = 0
    for ci in order:
        current.append(ci)
        count += len(shards[ci])
        if count >= round_tests:
            rounds.append(current)
            current, count = [], 0
    if current:
        rounds.append(current)
    return rounds


def final_rate_interval(
    executed_values: Sequence[float],
    executed_weights: Sequence[float],
    remaining_weights: Sequence[float],
    z: float,
) -> Tuple[float, float, float, float]:
    """(lo, hi, point rate, n_eff) bounding the campaign's *final* S1 estimate.

    Two constraints intersected:

    * the hard reachable bound — remaining tests are pre-drawn with known
      weights, so the final self-normalized estimate lies between "every
      remaining test fails" and "every remaining test passes" (exact, not
      statistical);
    * the Wilson score interval at ``z``, on the Kish effective sample size.

    The point estimate lies in both, so the intersection is never empty.
    """
    w_exec = float(np.sum(np.asarray(executed_weights, dtype=float))) if len(executed_weights) else 0.0
    if w_exec <= 0.0:
        return 0.0, 1.0, float("nan"), 0.0
    s = float(np.sum(np.asarray(executed_values, dtype=float)
                     * np.asarray(executed_weights, dtype=float)))
    w_rem = float(np.sum(np.asarray(remaining_weights, dtype=float))) if len(remaining_weights) else 0.0
    w_tot = w_exec + w_rem
    hard_lo, hard_hi = s / w_tot, (s + w_rem) / w_tot
    rate, n_eff = weighted_outcome_stats(executed_values, executed_weights)
    wil_lo, wil_hi = wilson_interval(rate * n_eff, n_eff, z)
    # the current estimate lies in both intervals mathematically; widen to
    # it so float rounding (Wilson hi at p_hat=1 computes to 1-1e-16) can
    # never produce an interval excluding the point
    lo = min(max(hard_lo, wil_lo), rate)
    hi = max(min(hard_hi, wil_hi), rate)
    return lo, hi, rate, n_eff
