# Port of repro/analysis/classify.py.  What differs:
# * Regions are traced by analysis/fx_walk.py (aten graphs, on the app's
#   device) instead of jaxpr_walk.py.
# * The damping probe is torch.func.jvp over the composed traced regions, on
#   the app's device, from the same mid-trajectory state (3 iterations) in
#   the same unit direction (np.random.default_rng(0) normals as float32,
#   normalised); the state's leaves keep their own types (jax makes int64
#   leaves int32, which no float path reads).
# Everything else (lattice, thresholds, confidences, payload) is unchanged.
"""Classify tracked data objects from region dataflow; emit a StaticPlan.

Classification lattice (per non-iterator candidate object, over one composed
main-loop iteration):

* ``dead`` — the object is overwritten before any region reads its crashed
  value, and its new value does not depend on its old one.  A stale NVM
  image is simply never consumed: skip.
* ``reconstructible`` — not self-dependent, but read before overwritten: a
  pure function of *other* objects' previous values, so it is rebuilt as
  soon as those are right: skip.
* ``crash-critical`` — the self-dependent update path contains a discrete
  primitive (``argmin``, data-dependent compares/selects/scatters), the
  object is an integer tally, or the app declares an ``exact-accumulator``
  hint: one stale input flips category membership or double-counts, and no
  remaining iterations repair it: persist.
* ``accumulator`` — a smooth self-dependent update.  Whether it
  self-corrects is *quantitative*: the damping probe pushes a unit jvp
  perturbation of the object through one composed iteration; a contraction
  factor below :data:`DAMPING_THRESHOLD` means the next iterations absorb a
  stale image (skip), above means the error survives long enough to exhaust
  the remaining-iteration budget (persist).

The jvp probe is only consulted on that smooth branch — through ``argmin``
and friends the derivative is an honest zero while the value dependence is
maximal, which is exactly why discrete detection is primitive-based.

Untraceable regions degrade *confidence*, not class, when the object has at
least one traced writer; objects with no traced writer fall back to
conservative crash-critical at low confidence.  Region confidences below
:data:`CONFIDENCE_THRESHOLD` are what ``plan_source="static+verify"`` still
measures with a campaign.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.cache_sim import CacheConfig
from ..core.crash_tester import PersistPlan
from ..core.selection import RegionSelection, select_regions_from_gains
from ..convert import state_to_torch
from .fx_walk import UNTRACED, RegionTrace, trace_region

#: jvp contraction factor separating self-correcting from fragile smooth
#: accumulators.  Calibrated on the suite: heat's parabolic smoother damps a
#: unit perturbation to ~0.15 per iteration (recomputes for free), while
#: sor's over-relaxed sweep (~0.93), mg's V-cycle (~0.64) and pagerank's
#: damped power iteration (~0.49) all keep enough of the error to spill
#: late crashes into S2.
DAMPING_THRESHOLD = 0.3

#: classification confidence below which static+verify still runs the
#: region's measurement campaign
CONFIDENCE_THRESHOLD = 0.6


@dataclass(frozen=True)
class ObjectReport:
    name: str
    klass: str                     # dead | reconstructible | accumulator | crash-critical
    decision: str                  # persist | skip
    confidence: float
    damping: Optional[float]       # jvp contraction factor (smooth branch only)
    rationale: str


@dataclass(frozen=True)
class RegionReport:
    index: int
    name: str
    decision: str                  # persist | skip
    confidence: float
    traced: bool
    write_bytes: int               # statically estimated bytes written per iteration
    rationale: str


@dataclass(frozen=True)
class StaticPlan:
    """The predicted persist plan, with the evidence that produced it."""

    app_name: str
    objects: Tuple[ObjectReport, ...]
    regions: Tuple[RegionReport, ...]
    region_overheads: Tuple[float, ...]
    damping_threshold: float = DAMPING_THRESHOLD
    confidence_threshold: float = CONFIDENCE_THRESHOLD

    def persist_objects(self) -> Tuple[str, ...]:
        return tuple(o.name for o in self.objects if o.decision == "persist")

    def object_report(self, name: str) -> ObjectReport:
        for o in self.objects:
            if o.name == name:
                return o
        raise KeyError(name)

    def region_decisions(self) -> Dict[str, str]:
        return {r.name: r.decision for r in self.regions}

    def uncertain_regions(self) -> List[int]:
        """Regions whose static decision static+verify still measures."""
        return [r.index for r in self.regions
                if r.confidence < self.confidence_threshold]

    def window_confidences(self) -> Tuple[float, ...]:
        """Per-region decision confidence, indexed by region position.

        Crash times inside an iteration's window map 1:1 onto code regions
        (:meth:`~repro.core.crash_tester.CrashTester.region_time_spans`), so
        this vector is the per-*window* prior the adaptive scheduler's
        importance sampler tilts crash-point draws with: low confidence ->
        more samples land there.
        """
        return tuple(
            r.confidence for r in sorted(self.regions, key=lambda r: r.index)
        )

    def write_traffic_bytes(self) -> int:
        return sum(r.write_bytes for r in self.regions)

    def region_selection(
        self,
        t_s: float = 0.03,
        tau: float = 0.0,
        freq_options: Tuple[int, ...] = (1, 2, 4, 8),
    ) -> RegionSelection:
        """Knapsack over the *predicted* persist regions: gain is the static
        confidence (no campaign ran, so there is no measured gain), overhead
        the same flush-cost estimate the measured workflow uses."""
        gains = {r.index: (r.confidence if r.decision == "persist" else 0.0)
                 for r in self.regions}
        overheads = {r.index: self.region_overheads[r.index] for r in self.regions}
        return select_regions_from_gains(
            gains, overheads, 0.0, t_s=t_s, tau=tau, freq_options=freq_options,
        )

    def persist_plan(
        self,
        t_s: float = 0.03,
        tau: float = 0.0,
        freq_options: Tuple[int, ...] = (1, 2, 4, 8),
    ) -> PersistPlan:
        sel = self.region_selection(t_s=t_s, tau=tau, freq_options=freq_options)
        return PersistPlan(objects=self.persist_objects(),
                           region_freq=sel.plan_freqs())

    # ------------------------------------------------------------- artifact
    def to_payload(self) -> Dict[str, object]:
        def _f(x: Optional[float]):
            return None if x is None or not np.isfinite(x) else float(x)

        return {
            "app": self.app_name,
            "damping_threshold": float(self.damping_threshold),
            "confidence_threshold": float(self.confidence_threshold),
            "objects": [
                {"name": o.name, "class": o.klass, "decision": o.decision,
                 "confidence": round(float(o.confidence), 6),
                 "damping": _f(o.damping), "rationale": o.rationale}
                for o in self.objects
            ],
            "regions": [
                {"index": r.index, "name": r.name, "decision": r.decision,
                 "confidence": round(float(r.confidence), 6),
                 "traced": bool(r.traced), "write_bytes": int(r.write_bytes),
                 "rationale": r.rationale}
                for r in self.regions
            ],
            "region_overheads": [round(float(x), 9) for x in self.region_overheads],
        }

    def spec(self) -> Dict[str, object]:
        return self.to_payload()

    @classmethod
    def from_payload(cls, d: Mapping[str, object]) -> "StaticPlan":
        return cls(
            app_name=str(d["app"]),
            objects=tuple(
                ObjectReport(
                    name=str(o["name"]), klass=str(o["class"]),
                    decision=str(o["decision"]),
                    confidence=float(o["confidence"]),
                    damping=None if o.get("damping") is None else float(o["damping"]),
                    rationale=str(o.get("rationale", "")),
                )
                for o in d["objects"]
            ),
            regions=tuple(
                RegionReport(
                    index=int(r["index"]), name=str(r["name"]),
                    decision=str(r["decision"]),
                    confidence=float(r["confidence"]),
                    traced=bool(r["traced"]),
                    write_bytes=int(r["write_bytes"]),
                    rationale=str(r.get("rationale", "")),
                )
                for r in d["regions"]
            ),
            region_overheads=tuple(float(x) for x in d["region_overheads"]),
            damping_threshold=float(d["damping_threshold"]),
            confidence_threshold=float(d["confidence_threshold"]),
        )


def app_device(app) -> str:
    """The device an app computes on (the CPU for an app that names none)."""
    return str(getattr(app, "device", "cpu"))


def _damping_probe(app, traces: List[RegionTrace], obj: str,
                   probe_iters: int = 3) -> Optional[float]:
    """||jvp|| of obj -> obj through one composed iteration of the traceable
    regions, at a mid-trajectory state with a deterministic unit direction."""
    state0 = app.init(0)
    if not np.issubdtype(np.asarray(state0[obj]).dtype, np.floating):
        return None
    regs = app.regions()
    s_mid = dict(state0)
    for _ in range(probe_iters):
        s_mid = app.run_iteration(s_mid)
    device = app_device(app)
    base = state_to_torch(s_mid, device)

    def f(x):
        s = dict(base)
        s[obj] = x
        for r, tr in zip(regs, traces):
            if tr.ok:
                s = {**s, **r.fn(dict(s))}
        return s[obj]

    x0 = base[obj]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(np.asarray(state0[obj]).shape).astype(np.float32)
    v = v / max(np.linalg.norm(v), 1e-30)
    v = torch.from_numpy(v).to(device=x0.device, dtype=x0.dtype)
    try:
        _, dv = torch.func.jvp(f, (x0,), (v,))
        return float(torch.linalg.vector_norm(dv))
    except Exception:  # noqa: BLE001 - probe failure degrades to conservative
        return None


def _classify_object(
    app,
    obj: str,
    state0: Mapping[str, np.ndarray],
    traces: List[RegionTrace],
    end_info: Mapping[str, Tuple[frozenset, frozenset]],
    read_before_write: bool,
    hints: Mapping[str, str],
    damping_threshold: float,
) -> ObjectReport:
    regs = app.regions()
    writers = [i for i, r in enumerate(regs) if obj in r.writes]
    traced_writers = [i for i in writers if traces[i].ok]
    coverage = (len(traced_writers) / len(writers)) if writers else 1.0
    deps, ops = end_info.get(obj, (frozenset({obj}), frozenset()))
    self_dep = obj in deps
    discrete = sorted(t for t in ops if t.startswith("discrete:"))
    untraced = UNTRACED in ops
    hint = hints.get(obj)

    if hint == "exact-accumulator":
        return ObjectReport(
            obj, "crash-critical", "persist", 0.9, None,
            "app-declared exact accumulator: re-execution double-counts, "
            "verification is exact",
        )
    if not writers:
        return ObjectReport(obj, "dead", "skip", 0.5, None,
                            "never written inside the main loop")
    if not self_dep and not read_before_write:
        return ObjectReport(
            obj, "dead", "skip", 0.95 * max(coverage, 0.5), None,
            "overwritten every iteration before any read: a stale NVM image "
            "is never consumed",
        )
    if not self_dep:
        return ObjectReport(
            obj, "reconstructible", "skip", 0.85 * max(coverage, 0.5), None,
            "pure function of other objects' previous values: rebuilt once "
            "those are restored",
        )
    if np.issubdtype(np.asarray(state0[obj]).dtype, np.integer):
        return ObjectReport(
            obj, "crash-critical", "persist", max(0.85 * coverage, 0.4), None,
            "integer self-accumulation: a lost increment is permanent",
        )
    if discrete:
        return ObjectReport(
            obj, "crash-critical", "persist", max(0.85 * coverage, 0.4), None,
            f"discrete primitives on the self-update path ({', '.join(discrete)}): "
            "stale inputs flip category membership, no contraction applies",
        )
    if untraced and coverage == 0.0:
        return ObjectReport(
            obj, "crash-critical", "persist", 0.35, None,
            "self-dependent with no traceable writer: conservative persist",
        )
    damping = _damping_probe(app, traces, obj)
    if damping is None:
        return ObjectReport(
            obj, "accumulator", "persist", 0.45, None,
            "smooth self-update but the damping probe failed: conservative persist",
        )
    conf = coverage * min(0.9, 0.55 + abs(damping - damping_threshold))
    if damping < damping_threshold:
        return ObjectReport(
            obj, "accumulator", "skip", conf, damping,
            f"self-correcting: one iteration damps a unit perturbation to "
            f"{damping:.3f} (< {damping_threshold}), remaining iterations "
            f"absorb a stale image",
        )
    return ObjectReport(
        obj, "accumulator", "persist", conf, damping,
        f"fragile accumulator: damping {damping:.3f} >= {damping_threshold}, "
        f"stale-image error survives into the acceptance budget",
    )


def analyze_app(
    app,
    cache: Optional[CacheConfig] = None,
    seed: int = 0,
    damping_threshold: float = DAMPING_THRESHOLD,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
) -> StaticPlan:
    """Trace, classify, and predict a persist plan for one registered app."""
    from ..core.workflow import estimate_region_overheads

    state0 = app.init(seed)
    regs = app.regions()
    # objects no region writes are rebuilt by restart_init: constants for
    # crash dataflow (read-only pin tables, link matrices, sources)
    all_writes = frozenset().union(*(frozenset(r.writes) for r in regs))
    consts = frozenset(state0) - all_writes
    traces = [trace_region(state0, r, const_objects=consts, device=app_device(app))
              for r in regs]
    candidates = [c for c in app.candidates if c != app.iterator_object]
    hints = app.static_hints()

    # compose regions in sweep order: end-of-iteration (deps, ops) of every
    # object in terms of start-of-iteration values
    cur: Dict[str, Tuple[frozenset, frozenset]] = {
        k: (frozenset({k}), frozenset()) for k in state0
    }
    read_before_write = {c: False for c in candidates}
    written = {c: False for c in candidates}
    for r, tr in zip(regs, traces):
        region_reads = tr.reads() if tr.ok else frozenset(r.reads) | frozenset(r.writes)
        for c in candidates:
            if c in region_reads and not written[c]:
                read_before_write[c] = True
        new: Dict[str, Tuple[frozenset, frozenset]] = {}
        for w in r.writes:
            srcs = tr.deps.get(w, frozenset())
            infos = [cur.get(i, (frozenset({i}), frozenset())) for i in srcs]
            deps = frozenset().union(*(d for d, _ in infos)) if infos else frozenset()
            ops = tr.ops.get(w, frozenset())
            for _, o in infos:
                ops = ops | o
            new[w] = (deps, ops)
        cur.update(new)
        for c in candidates:
            if c in r.writes:
                written[c] = True

    obj_reports = tuple(
        _classify_object(app, c, state0, traces, cur, read_before_write[c],
                         hints, damping_threshold)
        for c in candidates
    )
    by_name = {o.name: o for o in obj_reports}
    persist = {o.name for o in obj_reports if o.decision == "persist"}

    # region decision: a region flushes iff it writes (or hot-re-reads) a
    # persist-decided object — plus the iterator bookmark region, which is
    # always flushed whenever anything at all is persisted (paper fn. 3)
    region_reports = []
    for i, (r, tr) in enumerate(zip(regs, traces)):
        triggers = (set(r.writes) | set(r.hot_reads)) & persist
        iterator_trigger = (
            app.iterator_object in r.writes and bool(persist) and not triggers
        )
        at_stake = [by_name[c] for c in candidates
                    if c in set(r.writes) | set(r.hot_reads)]
        if triggers:
            conf = min(by_name[o].confidence for o in triggers)
            why = f"writes/hot-reads persist-decided {sorted(triggers)}"
            decision = "persist"
        elif iterator_trigger:
            conf = min(by_name[o].confidence for o in persist)
            why = "iterator bookmark region (flushes whenever anything persists)"
            decision = "persist"
        else:
            conf = min((o.confidence for o in at_stake), default=0.9)
            stake = sorted(o.name for o in at_stake)
            why = (f"touches only skip-decided objects {stake}" if stake
                   else "touches no tracked candidates")
            decision = "skip"
        region_reports.append(RegionReport(
            index=i, name=r.name, decision=decision, confidence=conf,
            traced=tr.ok, write_bytes=tr.write_bytes, rationale=why,
        ))

    block_bytes = cache.block_bytes if cache is not None else 64
    overheads = estimate_region_overheads(
        app, sorted(persist), block_bytes=block_bytes,
    ) if persist else [0.0 for _ in regs]

    return StaticPlan(
        app_name=app.name,
        objects=obj_reports,
        regions=tuple(region_reports),
        region_overheads=tuple(float(x) for x in overheads),
        damping_threshold=damping_threshold,
        confidence_threshold=confidence_threshold,
    )
