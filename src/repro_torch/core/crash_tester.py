# Port copy of repro/core/crash_tester.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""NVCT: crash-test campaigns for application recomputability (paper §3–4).

A campaign repeatedly: picks a uniformly random crash point, synthesises the
post-crash NVM image through the cache model (:mod:`repro.core.cache_sim`),
restarts the application from the image, runs it to completion and classifies
the outcome:

* **S1** — passes acceptance verification with no extra iterations
  (the paper's definition of *successful recomputation*);
* **S2** — passes, but needed extra iterations;
* **S3** — interruption (exception / non-finite blow-up during recompute);
* **S4** — verification still fails after 2x the original iteration budget.

Recomputability = |S1| / |tests| (paper §2.2).  Each record also carries the
per-object data-inconsistency rate, which feeds the Spearman selection
(:mod:`repro.core.selection`).

What a "crash" *is* is pluggable: a :class:`~repro.core.faults.FaultModel`
controls the crash-point distribution, cacheline tearing, image corruption
and crashes-during-recovery.  The default :class:`~repro.core.faults.PowerFail`
reproduces the historical single-clean-power-fail engine bit-for-bit.
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .blocks import inconsistent_rate
from .cache_sim import (
    ENGINES,
    CacheConfig,
    Flush,
    RegionEvents,
    Sweep,
    WindowTrace,
    resolve_nvm_image,
    resolve_window_images,
    simulate_window,
)
from .faults import FaultModel, PowerFail
from .regions import IterativeApp, Region, State, VerifyResult, object_blocks
from .trace_cache import WindowPayload, WindowTraceCache, shared_trace_cache


def default_engine() -> str:
    """Window/recompute engine when none is requested: ``REPRO_ENGINE`` in
    the environment, else ``"vec"`` (the engines are bit-for-bit identical,
    so the default is simply the fast one)."""
    eng = os.environ.get("REPRO_ENGINE", "vec")
    if eng not in ENGINES:
        raise ValueError(f"REPRO_ENGINE={eng!r}: unknown engine; have {ENGINES}")
    return eng


def _lane_batch_target() -> int:
    """Lanes the vec engine aims to stack per batched-recompute call
    (``REPRO_LANE_BATCH``); also the shard-chunk size of
    :meth:`CrashTester.run_shards`, which bounds how many resolved NVM
    images are held at once."""
    try:
        return max(1, int(os.environ.get("REPRO_LANE_BATCH", "64")))
    except ValueError:
        return 64


@dataclass(frozen=True)
class PersistPlan:
    """Which objects to flush, where, and how often.

    ``region_freq[k] = x`` flushes the plan's objects at the end of region
    ``k`` on iterations where ``iter_idx % x == 0`` (frequency interpolation
    of Eq. 5).  An empty ``region_freq`` means no EasyCrash flushes at all.
    """

    objects: Tuple[str, ...] = ()
    region_freq: Mapping[int, int] = field(default_factory=dict)

    @staticmethod
    def none() -> "PersistPlan":
        return PersistPlan((), {})

    @staticmethod
    def at_loop_end(objects: Sequence[str], app: IterativeApp, x: int = 1) -> "PersistPlan":
        """Persist at the end of each main-loop iteration (paper Fig 2a)."""
        last = len(app.regions()) - 1
        return PersistPlan(tuple(objects), {last: x})

    @staticmethod
    def best(objects: Sequence[str], app: IterativeApp) -> "PersistPlan":
        """Persist at every region, every iteration (paper's costly upper bound)."""
        return PersistPlan(tuple(objects), {k: 1 for k in range(len(app.regions()))})


@dataclass(frozen=True)
class CrashRecord:
    iter_idx: int
    region_idx: int
    frac: float
    inconsistency: Dict[str, float]
    outcome: str          # "S1" | "S2" | "S3" | "S4"
    extra_iters: int
    verify_metric: float
    #: importance weight of the test that produced this record (1.0 for the
    #: historical uniform draw); self-normalized estimators divide by the
    #: weight sum, so uniform campaigns are numerically unchanged
    weight: float = 1.0


@dataclass(frozen=True)
class PlannedTest:
    """One pre-drawn crash test: campaign randomness is fully resolved up
    front (same draw order as the historical serial engine), so execution
    order — serial, sharded, parallel, resumed — cannot change the result.

    ``fault_seed`` carries the test's fault-model entropy (torn-write /
    bit-flip / recovery-crash decisions), pre-drawn by the planner for models
    that need it; 0 for the default :class:`~repro.core.faults.PowerFail`,
    whose planning draws are exactly the historical two per test.

    ``weight`` is the importance weight when the campaign's crash points
    were drawn from a biased proposal (``CrashTester(sampler=...)``): the
    uniform-over-proposal likelihood ratio, 1.0 for the historical uniform
    draw.  It rides into the :class:`CrashRecord` so stores and estimators
    see it.
    """

    index: int        # position in the campaign (stable output ordering)
    crash_iter: int   # iteration whose window the crash falls in
    crash_t: int      # crash time inside the window, in block accesses
    fault_seed: int = 0
    weight: float = 1.0


@dataclass(frozen=True)
class CampaignResult:
    app_name: str
    plan: PersistPlan
    records: List[CrashRecord]
    golden_iters: int
    window_write_stats: Dict[str, float]

    @property
    def n(self) -> int:
        return len(self.records)

    def spec(self) -> Dict[str, object]:
        """Strict-JSON identity of this campaign's inputs and outcome."""
        return {
            "app": self.app_name,
            "plan": {
                "objects": list(self.plan.objects),
                "region_freq": sorted(
                    (int(k), int(v)) for k, v in self.plan.region_freq.items()
                ),
            },
            "n_tests": self.n,
            "golden_iters": int(self.golden_iters),
            "class_fractions": self.class_fractions(),
            "window_write_stats": {
                k: float(v) for k, v in sorted(self.window_write_stats.items())
            },
        }

    def class_fractions(self) -> Dict[str, float]:
        out = {c: 0.0 for c in ("S1", "S2", "S3", "S4")}
        for r in self.records:
            out[r.outcome] += 1
        return {c: v / max(1, self.n) for c, v in out.items()}

    def weighted_class_fractions(self) -> Dict[str, float]:
        """Self-normalized IS estimate of the S1–S4 rates: sum of record
        weights per class over the total weight.  For a uniform campaign
        (all weights 1.0) this is exactly :meth:`class_fractions`."""
        out = {c: 0.0 for c in ("S1", "S2", "S3", "S4")}
        total = 0.0
        for r in self.records:
            out[r.outcome] += r.weight
            total += r.weight
        if total <= 0.0:
            return {c: 0.0 for c in out}
        return {c: v / total for c, v in out.items()}

    @property
    def recomputability(self) -> float:
        return self.class_fractions()["S1"]

    @property
    def weighted_recomputability(self) -> float:
        """S1 rate under the self-normalized IS estimator (== plain
        :attr:`recomputability` for uniform weights)."""
        return self.weighted_class_fractions()["S1"]

    def effective_n(self) -> float:
        """Kish effective sample size of the campaign's weights."""
        w = np.array([r.weight for r in self.records], dtype=float)
        s2 = float(np.sum(w * w))
        return float(np.sum(w)) ** 2 / s2 if s2 > 0.0 else 0.0

    def per_region_recomputability(self) -> Dict[int, Tuple[float, int]]:
        """region_idx -> (recomputability c_k, sample count)."""
        groups: Dict[int, List[CrashRecord]] = {}
        for r in self.records:
            groups.setdefault(r.region_idx, []).append(r)
        return {
            k: (sum(1 for r in v if r.outcome == "S1") / len(v), len(v))
            for k, v in groups.items()
        }

    def vectors_for_selection(self, obj: str) -> Tuple[np.ndarray, np.ndarray]:
        """(inconsistency rates, success indicator) for Spearman analysis."""
        x = np.array([r.inconsistency.get(obj, 0.0) for r in self.records])
        y = np.array([1.0 if r.outcome == "S1" else 0.0 for r in self.records])
        return x, y


class CrashTester:
    """NVCT driver bound to one application and one persist plan."""

    def __init__(
        self,
        app: IterativeApp,
        plan: PersistPlan,
        cache: CacheConfig = CacheConfig(),
        seed: int = 0,
        max_extra_factor: float = 2.0,
        fault: Optional[FaultModel] = None,
        engine: Optional[str] = None,
        trace_cache: Optional[WindowTraceCache] = None,
        sampler=None,
        lane_batch: Optional[int] = None,
    ):
        """``engine`` selects the campaign hot path — ``"vec"`` (SoA window
        simulator, batched recompute for apps with ``supports_batched_step``)
        or ``"ref"`` (the historical per-access / per-test oracle); ``None``
        resolves :func:`default_engine`.  Results are bit-for-bit identical.

        ``lane_batch`` caps how many restart lanes the vec engine stacks per
        batched-recompute call (and per shard chunk in :meth:`run_shards`);
        ``None`` falls back to the ``REPRO_LANE_BATCH`` environment variable
        (default 64).  Like ``engine`` it is an execution-strategy knob, not
        an experiment parameter: campaign results and store fingerprints are
        identical at any value.

        ``trace_cache`` is the cross-campaign window cache; ``None`` uses the
        process-shared one (:func:`~repro.core.trace_cache.shared_trace_cache`).
        Pass a private :class:`~repro.core.trace_cache.WindowTraceCache` to
        isolate a tester (benchmarks measuring cold paths do).

        ``sampler`` replaces the fault model's crash-point draw with an
        importance-sampled one (duck-typed:
        ``draw(rng, planner) -> (crash_iter, crash_t, weight)`` plus a
        JSON-safe ``spec()``; see
        :class:`~repro.core.adaptive.StaticPriorSampler`).  Planning-only:
        workers executing pre-drawn shards never consult it."""
        self.app = app
        self.plan = plan
        self.cache = cache
        self.seed = seed
        self.max_extra_factor = max_extra_factor
        self.fault = fault if fault is not None else PowerFail()
        self.sampler = sampler
        self.lane_batch = lane_batch
        self.engine = engine if engine is not None else default_engine()
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; have {ENGINES}")
        self._trace_cache = trace_cache if trace_cache is not None else shared_trace_cache()
        self._golden_states: Optional[List[State]] = None
        self._golden_iters: int = 0
        self._golden_final: Optional[State] = None
        self._window_cache: Dict[int, Tuple[WindowTrace, Dict[int, Dict[str, np.ndarray]], int]] = {}
        self._iter_time: Optional[int] = None
        self._region_spans: Optional[List[Tuple[int, int]]] = None
        self._digest: Optional[str] = None
        # vec-engine fast paths: one canonical steady-state trace per
        # relative flush schedule, one init() per campaign for restart lanes
        self._canon_trace: Dict[tuple, Tuple[WindowTrace, int]] = {}
        self._init_base: Optional[State] = None

    # ---------------------------------------------------------------- golden
    def _ensure_golden(self) -> None:
        if self._golden_states is not None:
            return
        app = self.app
        state = app.init(self.seed)
        states = [
            {k: np.array(v, copy=True) for k, v in state.items()}
        ]
        it = 0
        while it < app.n_iters:
            state = app.run_iteration(state)
            it += 1
            states.append({k: np.array(v, copy=True) for k, v in state.items()})
            if app.converged(state, it):
                break
        self._golden_states = states
        self._golden_iters = it
        self._golden_final = state
        golden_verify = app.verify(state)
        if not golden_verify.passed:
            raise RuntimeError(
                f"golden run of {app.name} fails its own acceptance verification: "
                f"{golden_verify}"
            )

    @property
    def golden_iters(self) -> int:
        self._ensure_golden()
        return self._golden_iters

    def lane_batch_target(self) -> int:
        """Lanes the vec engine stacks per batched-recompute call: the
        constructor's ``lane_batch`` when given, else ``REPRO_LANE_BATCH``."""
        if self.lane_batch is not None:
            return max(1, int(self.lane_batch))
        return _lane_batch_target()

    def release_caches(self) -> None:
        """Drop the golden trajectory and window-image caches.

        Both re-materialise on demand (``_ensure_golden`` is deterministic),
        so this only trades recompute for memory — the workflow orchestrator
        calls it once a campaign's shards are assembled, so W+2 coexisting
        testers don't pin W+2 full golden trajectories.
        """
        self._golden_states = None
        self._golden_final = None
        self._window_cache = {}

    # ---------------------------------------------------------------- events
    def _tracked_objects(self, state: State) -> List[str]:
        regs = self.app.regions()
        names: List[str] = []
        for r in regs:
            for o in tuple(r.reads) + tuple(r.writes):
                if o not in names and o in state:
                    names.append(o)
        return names

    def _region_events(self, region: Region, region_idx: int, iter_idx: int) -> List[object]:
        events: List[object] = []
        hot = tuple(region.hot_reads)
        for o in region.reads:
            if o in hot:
                continue  # hot objects ride along with the big sweeps
            events.append(Sweep(o, write=False, hot=hot))
        for o in region.writes:
            events.append(Sweep(o, write=True, hot=hot))
        x = self.plan.region_freq.get(region_idx)
        if x and iter_idx % x == 0:
            for o in self.plan.objects:
                events.append(Flush(o))
        return events

    def _window_payload(self, state0: State, first: int, last: int) -> WindowPayload:
        """The plan-independent half of a window simulation: re-run the
        region functions over iterations [first, last] from ``state0`` (not
        mutated) and snapshot each region occurrence's written values."""
        app = self.app
        regs = app.regions()
        state = {k: np.array(v, copy=True) for k, v in state0.items()}
        tracked = self._tracked_objects(state)
        obj_blocks = object_blocks(state, tracked, self.cache.block_bytes)
        seq_values: Dict[int, Dict[str, np.ndarray]] = {}
        meta: List[Tuple[int, int, int]] = []
        seq = 0
        for it in range(first, last + 1):
            for ridx, region in enumerate(regs):
                state = region.fn(state)
                seq_values[seq] = {
                    o: np.array(state[o], copy=True) for o in region.writes if o in state
                }
                meta.append((seq, it, ridx))
                seq += 1
        return WindowPayload(seq_values, obj_blocks, tuple(meta))

    def _trace_from_payload(
        self, payload: WindowPayload, last: int
    ) -> Tuple[WindowTrace, Dict[int, Dict[str, np.ndarray]], int]:
        """The plan-dependent half: rebuild the event stream (flushes come
        from the persist plan) and run the selected cache-sim engine."""
        regs = self.app.regions()
        region_events = [
            RegionEvents(
                seq=seq,
                iter_idx=it,
                region_idx=ridx,
                events=tuple(self._region_events(regs[ridx], ridx, it)),
            )
            for (seq, it, ridx) in payload.meta
        ]
        trace = simulate_window(
            self.cache, payload.obj_blocks, region_events, engine=self.engine
        )
        crash_span_start = next(t0 for (s, it, ridx, t0, t1) in trace.spans if it == last)
        return trace, payload.seq_values, crash_span_start

    def _simulate_window_from(
        self, state0: State, first: int, last: int
    ) -> Tuple[WindowTrace, Dict[int, Dict[str, np.ndarray]], int]:
        """Simulate iterations [first, last] starting from ``state0``.

        ``state0`` is not mutated.  Returns the window trace, the per-region
        written values, and the time the *last* iteration's span starts at
        (crash times are drawn from the last iteration of a window).
        """
        return self._trace_from_payload(
            self._window_payload(state0, first, last), last
        )

    def _flush_schedule(self, first: int, last: int) -> Tuple[tuple, tuple]:
        """The window's *effective* flush schedule — which (iteration,
        region) slots actually fire, and what they flush.  Plans that fire
        nothing inside a window normalize to the same (empty) key, so e.g. a
        region-isolated campaign shares the baseline trace for windows its
        flush frequency skips."""
        fired = tuple(
            (it, ridx)
            for it in range(first, last + 1)
            for ridx, x in sorted(self.plan.region_freq.items())
            if x and it % x == 0
        )
        return (fired, tuple(self.plan.objects)) if fired else ((), ())

    def _simulate_crash_window(
        self, crash_iter: int
    ) -> Tuple[WindowTrace, Dict[int, Dict[str, np.ndarray]], int]:
        """Simulate iterations [crash_iter-1, crash_iter] once; cache result.

        Two cache layers: the tester-local ``_window_cache`` (this campaign)
        and the process-shared :class:`WindowTraceCache`, which lets the
        other campaigns of a workflow — and replays of the same plan under
        other fault models — reuse the window instead of re-simulating it.
        """
        if crash_iter in self._window_cache:
            return self._window_cache[crash_iter]
        self._ensure_golden()
        first = max(0, crash_iter - 1)
        shared = self._trace_cache
        wkey = (shared.app_token(self.app), self._state_digest(), first, crash_iter)
        tkey = wkey + (
            int(self.cache.capacity_blocks),
            int(self.cache.block_bytes),
            self._flush_schedule(first, crash_iter),
            self.engine,
        )
        result = shared.get_trace(tkey)
        if result is None:
            payload = shared.get_payload(wkey + (int(self.cache.block_bytes),))
            if payload is None:
                payload = self._window_payload(
                    self._golden_states[first], first, crash_iter
                )
                shared.put_payload(wkey + (int(self.cache.block_bytes),), payload)
            result = self._trace_from_canonical(payload, first, crash_iter)
            if result is None:
                result = self._trace_from_payload(payload, crash_iter)
                self._put_canonical(result[0], first, crash_iter)
            shared.put_trace(tkey, result)
        self._window_cache[crash_iter] = result
        return result

    # Steady-state windows ([ci-1, ci] with ci >= 2) start from the same
    # cold cache and replay the same event stream — the plan's flushes are
    # the only per-window variation, and only through the *relative* firing
    # pattern.  The cache dynamics are therefore shift-invariant in the
    # crash iteration: one simulated trace serves every steady window with
    # the same relative schedule, after relabeling the iteration indices in
    # its region spans.  The ref oracle never takes this path.
    def _canon_key(self, first: int, last: int) -> Optional[tuple]:
        if self.engine != "vec" or first != last - 1 or first < 1:
            return None
        fired, objs = self._flush_schedule(first, last)
        return (tuple((it - first, ridx) for it, ridx in fired), objs)

    def _put_canonical(self, trace: WindowTrace, first: int, last: int) -> None:
        key = self._canon_key(first, last)
        if key is not None and key not in self._canon_trace:
            self._canon_trace[key] = (trace, first)

    def _trace_from_canonical(
        self, payload: WindowPayload, first: int, last: int
    ) -> Optional[Tuple[WindowTrace, Dict[int, Dict[str, np.ndarray]], int]]:
        from dataclasses import replace

        key = self._canon_key(first, last)
        if key is None or key not in self._canon_trace:
            return None
        canon, canon_first = self._canon_trace[key]
        if canon.obj_blocks != payload.obj_blocks:
            return None
        delta = first - canon_first
        spans = [(s, it + delta, r, t0, t1) for (s, it, r, t0, t1) in canon.spans]
        trace = canon if delta == 0 else replace(canon, spans=spans)
        crash_span_start = next(t0 for (s, it, r, t0, t1) in trace.spans if it == last)
        return trace, payload.seq_values, crash_span_start

    # -------------------------------------------------------------- planning
    def region_time_spans(self) -> List[Tuple[int, int]]:
        """Per-region ``(t0, t1)`` offsets within one iteration's window clock.

        ``simulate_window`` advances time one unit per swept block (hot
        refreshes and flushes are free), so region span boundaries are pure
        arithmetic over object sizes — campaign planning never needs to
        simulate a window.  Fault models use these spans to bias crash-point
        draws toward specific regions.
        """
        if self._region_spans is not None:
            return self._region_spans
        self._ensure_golden()
        state0 = self._golden_states[0]
        tracked = self._tracked_objects(state0)
        blocks = object_blocks(state0, tracked, self.cache.block_bytes)
        spans: List[Tuple[int, int]] = []
        t = 0
        for region in self.app.regions():
            t0 = t
            hot = tuple(region.hot_reads)
            for o in region.reads:
                if o not in hot and o in blocks:
                    t += blocks[o]
            for o in region.writes:
                if o in blocks:
                    t += blocks[o]
            spans.append((t0, t))
        self._region_spans = spans
        return spans

    def _iter_access_time(self) -> int:
        """Block accesses one iteration contributes to a window's clock."""
        if self._iter_time is not None:
            return self._iter_time
        spans = self.region_time_spans()
        self._iter_time = spans[-1][1] if spans else 0
        return self._iter_time

    def window_bounds(self, crash_iter: int) -> Tuple[int, int]:
        """(t_lo, t_end) of the crash span: the window is iterations
        [crash_iter-1, crash_iter] and crash times are drawn from the last."""
        it_t = self._iter_access_time()
        if crash_iter >= 1:
            return it_t, 2 * it_t
        return 0, it_t

    # historical (pre-fault-model) spelling, kept for callers and tests
    _window_bounds = window_bounds

    def _draw_test(self, rng: np.random.Generator, index: int) -> PlannedTest:
        """One planned test via the fault model's crash-point hook; models
        that need per-test entropy get a fault seed drawn *after* the crash
        point, so the default model's draw stream stays the historical one.
        An attached ``sampler`` takes over the crash-point draw (and supplies
        the importance weight); the fault model keeps its other hooks."""
        if self.sampler is not None:
            crash_iter, crash_t, weight = self.sampler.draw(rng, self)
        else:
            crash_iter, crash_t = self.fault.draw_crash_point(rng, self)
            weight = 1.0
        fault_seed = (
            int(rng.integers(0, np.iinfo(np.int64).max))
            if self.fault.uses_test_entropy
            else 0
        )
        return PlannedTest(index, crash_iter, crash_t, fault_seed, weight)

    def plan_campaign(self, n_tests: int, seed: Optional[int] = None) -> List[PlannedTest]:
        """Pre-draw every crash point (and per-test fault entropy) with the
        campaign RNG.

        For the default :class:`~repro.core.faults.PowerFail` model the draw
        order (crash iteration, then crash time within the iteration's
        window) is exactly the historical serial engine's, so a planned
        campaign at ``n_workers=1`` reproduces it bit-for-bit.
        """
        self._ensure_golden()
        rng = np.random.default_rng(self.seed if seed is None else seed)
        return [self._draw_test(rng, i) for i in range(n_tests)]

    # ----------------------------------------------------------------- tests
    def run_one(self, rng: np.random.Generator) -> CrashRecord:
        self._ensure_golden()
        test = self._draw_test(rng, 0)
        (_, record), = self.run_window_tests(test.crash_iter, [test])
        return record

    def run_window_tests(
        self, crash_iter: int, tests: Sequence[PlannedTest]
    ) -> List[Tuple[int, CrashRecord]]:
        """Execute all planned tests of one crash window (one shard).

        The window is simulated once and **all** its crash points are
        resolved in a single vectorial pass over the window's write-back
        records (:func:`resolve_window_images`).  On the ``"vec"`` engine,
        apps that declare ``supports_batched_step`` then run the restart /
        recompute phase as stacked lanes with per-lane early-exit masks
        (:meth:`_classify_lanes_batched`) instead of one Python loop per
        test; results are bit-for-bit the serial classification.
        """
        items = self._prepare_window_items(crash_iter, tests)
        outcomes = self._classify_items(items, crash_iter)
        return [
            self._record_for(crash_iter, item, outcome)
            for item, outcome in zip(items, outcomes)
        ]

    def _prepare_window_items(
        self, crash_iter: int, tests: Sequence[PlannedTest]
    ) -> List[dict]:
        """Simulate + resolve one window: everything up to (but excluding)
        the restart/classification phase, one dict per planned test."""
        self._ensure_golden()
        app = self.app
        trace, seq_values, _ = self._simulate_crash_window(crash_iter)
        first = max(0, crash_iter - 1)
        start_values = {
            o: self._golden_states[first][o]
            for o in trace.obj_blocks
            if o in self._golden_states[first]
        }
        candidates = [o for o in app.candidates if o in start_values]
        chronic = self._chronic_base(candidates, crash_iter) if crash_iter >= 1 else None
        tearing = [
            self.fault.torn_blocks(t, trace, self.cache.block_bytes) for t in tests
        ]
        nvms, lives = resolve_window_images(
            trace, [t.crash_t for t in tests],
            {o: start_values[o] for o in candidates},
            seq_values, self.cache.block_bytes,
            chronic_base=chronic,
            tearing=tearing,
        )

        protected = tuple(self.plan.objects)
        if app.iterator_object:
            protected += (app.iterator_object,)
        items: List[dict] = []
        for test, nvm, live in zip(tests, nvms, lives):
            seq, it, region_idx, t0, t1 = trace.span_for_time(test.crash_t)
            frac = (test.crash_t - t0) / max(1, (t1 - t0))
            nvm = self.fault.corrupt_image(test, nvm, protected)
            inconsistency = {o: inconsistent_rate(nvm[o], live[o]) for o in candidates}

            # All candidates restart from the NVM image (paper §5.1: "the
            # candidates are directly read from NVM"); the plan only controls
            # which get *flushed* (and therefore how consistent they are).
            # The loop iterator is always flushed at iteration end (paper
            # fn. 3), so its NVM value is the bookmarked restart iteration,
            # not the torn cache-model value.
            persisted = dict(nvm)
            if app.iterator_object and app.iterator_object in persisted:
                bookmark = np.asarray(persisted[app.iterator_object])
                persisted[app.iterator_object] = np.full_like(bookmark, crash_iter)
            items.append({
                "test": test,
                "region_idx": region_idx,
                "frac": float(frac),
                "inconsistency": inconsistency,
                "persisted": persisted,
            })
        return items

    def _classify_items(
        self, items: Sequence[dict], crash_iter: int
    ) -> List[Tuple[str, int, float]]:
        """Classify prepared test items; batches eligible lanes on ``vec``."""
        results: List[Optional[Tuple[str, int, float]]] = [None] * len(items)
        lanes: List[Tuple[int, dict]] = []
        batchable = self.engine == "vec" and self.app.supports_batched_step
        for i, item in enumerate(items):
            test = item["test"]
            recovery = self.fault.recovery_plan(test, crash_iter, self._golden_iters)
            if recovery is not None:
                # recovery-from-recovery simulates a fresh window on the live
                # trajectory: inherently per-lane, never batched
                results[i] = self._restart_with_recovery_crash(
                    item["persisted"], crash_iter, test, recovery
                )
            elif batchable:
                lanes.append((i, item))
            else:
                results[i] = self._restart_and_classify(item["persisted"], crash_iter)
        if lanes:
            for (i, _), outcome in zip(
                lanes,
                self._classify_lanes_batched(
                    [(item["persisted"], crash_iter) for _, item in lanes]
                ),
            ):
                results[i] = outcome
        return results  # type: ignore[return-value]

    def _record_for(
        self, crash_iter: int, item: dict, outcome: Tuple[str, int, float]
    ) -> Tuple[int, CrashRecord]:
        kind, extra, metric = outcome
        return (
            item["test"].index,
            CrashRecord(
                iter_idx=crash_iter,
                region_idx=item["region_idx"],
                frac=item["frac"],
                inconsistency=item["inconsistency"],
                outcome=kind,
                extra_iters=extra,
                verify_metric=metric,
                weight=float(item["test"].weight),
            ),
        )

    # ------------------------------------------------- batched lane recompute
    class _Lane:
        __slots__ = ("index", "state", "it", "extra", "phase", "last_metric")

        def __init__(self, index: int, state: State, it: int):
            self.index = index
            self.state = state
            self.it = it
            self.extra = 0
            # "A": run_to_completion; "B0": awaiting entry verify;
            # "B": extra iterations; "done": classified
            self.phase = "A"
            self.last_metric = float("nan")

    @staticmethod
    def _call_padded(fn, states: List[State], *extra_lists):
        """Call an app ``*_batch`` hook with the lane list padded to the next
        power-of-two length.  Stacked hooks jit-compile per batch shape; as
        lanes finish, an unpadded batch would shrink by ones and recompile
        every round.  Padding replicates lane 0 (every hook is lane-
        independent, so the real lanes' outputs are untouched) and the
        padded tail of the result is dropped."""
        n = len(states)
        b = 1
        while b < n:
            b <<= 1
        if b == n:
            return fn(states, *extra_lists)
        pad = b - n
        padded = list(states) + [states[0]] * pad
        pextra = [list(e) + [e[0]] * pad for e in extra_lists]
        return fn(padded, *pextra)[:n]

    def _step_lanes(self, lanes: List["CrashTester._Lane"]) -> List["CrashTester._Lane"]:
        """One batched iteration for every lane; on a batch-level failure,
        falls back to per-lane serial steps and returns the lanes whose
        serial step raised (their exception is theirs alone)."""
        app = self.app
        try:
            new_states = self._call_padded(
                app.run_iteration_batch, [l.state for l in lanes]
            )
        except Exception as e:  # noqa: BLE001 - attribute the failure per lane
            import warnings

            warnings.warn(
                f"{app.name}: run_iteration_batch raised ({e!r}); falling "
                f"back to per-lane serial steps — the vec engine is paying "
                f"for a broken batched hook",
                RuntimeWarning, stacklevel=2,
            )
            failed = []
            for l in lanes:
                try:
                    l.state = app.run_iteration(l.state)
                except Exception:  # noqa: BLE001
                    failed.append(l)
            return failed
        for l, s in zip(lanes, new_states):
            l.state = s
        return []

    def _restart_init_cached(self, persisted: Mapping[str, np.ndarray]) -> State:
        """vec-path ``restart_init``: ``init()`` is deterministic in the
        seed, so restart lanes deep-copy one memoized base state instead of
        re-running it per lane.  Apps overriding ``restart_init`` keep their
        own semantics (and cost)."""
        if type(self.app).restart_init is not IterativeApp.restart_init:
            return self.app.restart_init(self.seed, persisted)
        if self._init_base is None:
            self._init_base = self.app.init(self.seed)
        state = {k: np.array(v, copy=True) for k, v in self._init_base.items()}
        for k, v in persisted.items():
            if k in state:
                state[k] = np.array(v, copy=True).astype(state[k].dtype, copy=False)
        return state

    def _classify_lanes_batched(
        self, lanes: Sequence[Tuple[Mapping[str, np.ndarray], int]]
    ) -> List[Tuple[str, int, float]]:
        """Stacked-lane replica of :meth:`_restart_and_classify`.

        All lanes advance together through ``run_iteration_batch`` — one
        dispatch per step for the whole batch instead of one per region per
        test — while per-lane masks replicate the serial control flow
        exactly: the run-to-completion loop with its converged() early exit
        (phase A), the acceptance verify (B0), and the extra-iteration loop
        up to the recompute budget (phase B).  Any per-lane exception — in
        restart, a blown-up convergence check, a verify — classifies that
        lane S3 with the serial path's (0, nan) payload.  Lanes may enter
        with different restart iterations (cross-window batches do).
        """
        app = self.app
        budget = int(self.max_extra_factor * self._golden_iters)
        golden_iters = self._golden_iters
        out: List[Optional[Tuple[str, int, float]]] = [None] * len(lanes)
        live: List[CrashTester._Lane] = []
        for i, (persisted, restart_iter) in enumerate(lanes):
            try:
                state = self._restart_init_cached(persisted)
            except Exception:  # noqa: BLE001 - serial path: any failure is S3
                out[i] = ("S3", 0, float("nan"))
                continue
            lane = CrashTester._Lane(i, state, restart_iter)
            if lane.it >= golden_iters:
                lane.phase = "B0"  # run_to_completion would execute nothing
            live.append(lane)

        # jit-resident phase A: apps with a lane driver run the whole
        # run-to-completion loop in one donated-buffer dispatch per bucket
        # instead of one run_iteration_batch dispatch per iteration; lanes
        # the driver cannot decide bit-exactly (blow-ups, overflow screens)
        # come back flagged and are reclassified through the serial path,
        # which also owns their exception capture (S3 semantics untouched)
        a_entry = [l for l in live if l.phase == "A"]
        if a_entry and app.supports_lane_driver:
            try:
                sts, nits, oks = app.advance_lanes(
                    [l.state for l in a_entry], [l.it for l in a_entry],
                    golden_iters,
                )
            except Exception as e:  # noqa: BLE001 - driver is an optimization
                import warnings

                warnings.warn(
                    f"{app.name}: advance_lanes raised ({e!r}); falling back "
                    f"to the host-loop phase A — the lane driver is broken",
                    RuntimeWarning, stacklevel=2,
                )
            else:
                for l, s, nit, ok in zip(a_entry, sts, nits, oks):
                    if ok:
                        l.state = s
                        l.it = int(nit)
                        l.phase = "B0"
                    else:
                        out[l.index] = self._restart_and_classify(*lanes[l.index])
                        l.phase = "done"
                live = [l for l in live if l.phase != "done"]

        active = live
        while active:
            # entry verifies for lanes that just finished the run phase
            b0 = [l for l in active if l.phase == "B0"]
            if b0:
                for l, res in zip(b0, self._call_padded(app.verify_batch, [l.state for l in b0])):
                    if isinstance(res, BaseException):
                        out[l.index] = ("S3", 0, float("nan"))
                        l.phase = "done"
                    elif res.passed:
                        out[l.index] = ("S1", 0, res.metric)
                        l.phase = "done"
                    elif l.it >= budget:
                        out[l.index] = ("S4", 0, res.metric)
                        l.phase = "done"
                    else:
                        l.phase = "B"
            active = [l for l in active if l.phase != "done"]
            if not active:
                break

            # one batched step for every still-running lane, A and B alike
            for l in self._step_lanes(active):
                out[l.index] = ("S3", 0, float("nan"))
                l.phase = "done"
            active = [l for l in active if l.phase != "done"]

            a_lanes = [l for l in active if l.phase == "A"]
            for l in a_lanes:
                l.it += 1
            if a_lanes:
                convs = self._call_padded(
                    app.converged_batch,
                    [l.state for l in a_lanes], [l.it for l in a_lanes],
                )
                for l, c in zip(a_lanes, convs):
                    if isinstance(c, BaseException):
                        out[l.index] = ("S3", 0, float("nan"))
                        l.phase = "done"
                    elif c or l.it >= golden_iters:
                        l.phase = "B0"

            b_lanes = [l for l in active if l.phase == "B"]
            for l in b_lanes:
                l.it += 1
                l.extra += 1
            if b_lanes:
                for l, res in zip(
                    b_lanes,
                    self._call_padded(app.verify_batch, [l.state for l in b_lanes]),
                ):
                    if isinstance(res, BaseException):
                        out[l.index] = ("S3", 0, float("nan"))
                        l.phase = "done"
                    elif res.passed:
                        out[l.index] = ("S2", l.extra, res.metric)
                        l.phase = "done"
                    elif l.it >= budget:
                        out[l.index] = ("S4", l.extra, res.metric)
                        l.phase = "done"
            active = [l for l in active if l.phase != "done"]
        return out  # type: ignore[return-value]

    def _chronic_base(self, candidates, crash_iter: int) -> Dict[str, np.ndarray]:
        """Steady-state base values for chronically-cached blocks: the last
        flushed image if the plan ever flushes the object, else the initial
        value (paper §8: small hot objects leave only ancient data in NVM)."""
        app = self.app
        regs = app.regions()
        written = set()
        for r in regs:
            written.update(r.writes)
        out: Dict[str, np.ndarray] = {}
        for o in candidates:
            if o not in written:
                continue
            flushed_iters = []
            if o in self.plan.objects:
                for k, x in self.plan.region_freq.items():
                    if x:
                        cand = ((crash_iter - 1) // x) * x
                        if cand >= 0:
                            flushed_iters.append(cand)
            if flushed_iters:
                f = max(flushed_iters)
                out[o] = self._golden_states[min(f + 1, len(self._golden_states) - 1)][o]
            else:
                out[o] = self._golden_states[0][o]
        return out

    def _finish_classify(self, state: State, it: int) -> Tuple[str, int, float]:
        """Classify a finished recompute run: S1 (passes), S2 (passes after
        extra iterations, up to the budget), S4 (budget exhausted)."""
        app = self.app
        budget = int(self.max_extra_factor * self._golden_iters)
        res = app.verify(state)
        if res.passed:
            return "S1", 0, res.metric
        extra = 0
        while it < budget:
            state = app.run_iteration(state)
            it += 1
            extra += 1
            res = app.verify(state)
            if res.passed:
                return "S2", extra, res.metric
        return "S4", extra, res.metric

    def _classify_test(
        self, persisted: Mapping[str, np.ndarray], restart_iter: int, test: PlannedTest
    ) -> Tuple[str, int, float]:
        """Restart-and-classify, routed through the fault model's recovery
        hook: models may crash the recompute run itself."""
        recovery = self.fault.recovery_plan(test, restart_iter, self._golden_iters)
        if recovery is None:
            return self._restart_and_classify(persisted, restart_iter)
        return self._restart_with_recovery_crash(persisted, restart_iter, test, recovery)

    def _restart_and_classify(
        self, persisted: Mapping[str, np.ndarray], restart_iter: int
    ) -> Tuple[str, int, float]:
        app = self.app
        golden_iters = self._golden_iters
        try:
            state = app.restart_init(self.seed, persisted)
            state, executed = app.run_to_completion(state, restart_iter, golden_iters)
            return self._finish_classify(state, restart_iter + executed)
        except Exception:  # incl. FloatingPointError blow-ups
            return "S3", 0, float("nan")

    def _restart_with_recovery_crash(
        self,
        persisted: Mapping[str, np.ndarray],
        restart_iter: int,
        test: PlannedTest,
        recovery: Tuple[int, float],
    ) -> Tuple[str, int, float]:
        """Recovery-from-recovery: run the recompute up to the second crash's
        window, simulate that window on the *live recompute trajectory*,
        resolve the second NVM image and restart again.

        The second window starts cache-consistent and carries no chronic
        base (the recompute trajectory is not in the steady-state regime the
        chronic adjustment models).  If the recompute converges before the
        second crash iteration, the run simply finished first and is
        classified as usual.
        """
        app = self.app
        recrash_iter, u = recovery
        try:
            state = app.restart_init(self.seed, persisted)
            it = restart_iter
            w_first = max(restart_iter, recrash_iter - 1)
            while it < w_first:
                state = app.run_iteration(state)
                it += 1
                if app.converged(state, it):
                    return self._finish_classify(state, it)

            trace, seq_values, span_start = self._simulate_window_from(
                state, w_first, recrash_iter
            )
            span = max(1, trace.t_end - span_start)
            crash_t2 = span_start + min(int(u * span), span - 1)
            candidates = [
                o for o in app.candidates if o in state and o in trace.obj_blocks
            ]
            image = resolve_nvm_image(
                trace, crash_t2,
                {o: state[o] for o in candidates},
                seq_values, self.cache.block_bytes,
            )
            persisted2 = dict(image)
            if app.iterator_object and app.iterator_object in persisted2:
                bookmark = np.asarray(persisted2[app.iterator_object])
                persisted2[app.iterator_object] = np.full_like(bookmark, recrash_iter)
            state2 = app.restart_init(self.seed, persisted2)
            state2, executed = app.run_to_completion(
                state2, recrash_iter, self._golden_iters
            )
            return self._finish_classify(state2, recrash_iter + executed)
        except Exception:  # incl. FloatingPointError blow-ups
            return "S3", 0, float("nan")

    # -------------------------------------------------------------- campaign
    def _state_digest(self) -> str:
        """Digest of the golden run's initial state: distinguishes same-named
        apps with different problem configurations (grid, tolerance, data
        seed), whose crash records must never be mixed in one store."""
        import hashlib

        if self._digest is not None:
            return self._digest
        self._ensure_golden()
        h = hashlib.sha256()
        for name in sorted(self._golden_states[0]):
            arr = np.ascontiguousarray(self._golden_states[0][name])
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        self._digest = h.hexdigest()[:16]
        return self._digest

    def _fingerprint(self, n_tests: int, seed: int) -> Dict[str, object]:
        """Identity of a campaign for the resume store: any change here means
        stored shard results are not reusable.  Values must survive a JSON
        round-trip unchanged (the store compares the parsed header against
        this dict), so: only str/int/float/bool, lists of lists — no tuples.
        """
        fp: Dict[str, object] = {
            "store_version": 1,
            "app": self.app.name,
            "state_digest": self._state_digest(),
            "n_tests": int(n_tests),
            "seed": int(seed),
            "golden_iters": int(self.golden_iters),
            "plan_objects": list(self.plan.objects),
            "plan_freq": sorted([int(k), int(v)] for k, v in self.plan.region_freq.items()),
            "cache_blocks": int(self.cache.capacity_blocks),
            "block_bytes": int(self.cache.block_bytes),
            "max_extra_factor": float(self.max_extra_factor),
            # a store is bound to one failure model: resuming a PowerFail
            # store with, say, TornWrite would silently mix taxonomies
            "fault": self.fault.spec(),
        }
        # only when a sampler is attached, so every historical (uniform)
        # fingerprint is byte-identical — but an importance-sampled store can
        # never be resumed with different weights (or none at all)
        if self.sampler is not None:
            fp["sampler"] = self.sampler.spec()
        return fp

    def _shards(self, tests: Sequence[PlannedTest]) -> Dict[int, List[PlannedTest]]:
        """Group planned tests by crash window; the shard id is the window's
        crash iteration.  Within a shard tests keep campaign order."""
        shards: Dict[int, List[PlannedTest]] = {}
        for t in tests:
            shards.setdefault(t.crash_iter, []).append(t)
        return shards

    # --------------------------------------------------- shard-level campaign API
    # run_campaign decomposes into three order-independent pieces so that an
    # external scheduler (the workflow orchestrator) can interleave shards of
    # *different* campaigns on one shared worker pool:
    #   plan_shards       -> the campaign's full shard map (pure planning)
    #   run_window_tests  -> execute one shard (anywhere, any order)
    #   assemble_campaign -> deterministic CampaignResult from shard results
    def plan_shards(
        self, n_tests: int, seed: Optional[int] = None
    ) -> Tuple[List[PlannedTest], Dict[int, List[PlannedTest]]]:
        """Plan a campaign and group it into shards (one per crash window)."""
        tests = self.plan_campaign(n_tests, seed)
        return tests, self._shards(tests)

    def run_shards(
        self,
        shards: Mapping[int, Sequence[PlannedTest]],
        on_shard=None,
    ) -> Dict[int, List[Tuple[int, CrashRecord]]]:
        """Execute several shards in-process, batching lanes **across**
        windows.

        CI-sized campaigns put only one or two tests in each crash window, so
        batching inside a single shard barely amortizes anything.  Here the
        vec engine groups consecutive shards into chunks of up to
        ``REPRO_LANE_BATCH`` lanes (restart states of one app all share
        shapes), resolves each window's images, then classifies the whole
        chunk through :meth:`_classify_lanes_batched`.  ``on_shard(ci,
        records)`` fires as each shard's records are assembled — after its
        chunk completes, which is also the durability granularity when the
        caller appends to a campaign store.  Results are identical to
        calling :meth:`run_window_tests` per shard, in any order.
        """
        use_batch = self.engine == "vec" and self.app.supports_batched_step
        out: Dict[int, List[Tuple[int, CrashRecord]]] = {}
        if not use_batch:
            for ci, ts in shards.items():
                recs = self.run_window_tests(ci, ts)
                out[ci] = recs
                if on_shard is not None:
                    on_shard(ci, recs)
            return out

        target = self.lane_batch_target()
        chunk: List[Tuple[int, Sequence[PlannedTest]]] = []
        lanes_in_chunk = 0
        for ci, ts in shards.items():
            chunk.append((ci, ts))
            lanes_in_chunk += len(ts)
            if lanes_in_chunk >= target:
                self._run_shard_chunk(chunk, out, on_shard)
                chunk, lanes_in_chunk = [], 0
        if chunk:
            self._run_shard_chunk(chunk, out, on_shard)
        return out

    def _run_shard_chunk(self, chunk, out, on_shard) -> None:
        """Prepare every shard of the chunk, classify all lanes at once."""
        prepared = [(ci, ts, self._prepare_window_items(ci, ts)) for ci, ts in chunk]
        results: Dict[int, List[Tuple[str, int, float]]] = {}
        batch_lanes: List[Tuple[int, int, dict]] = []  # (ci, item_idx, item)
        for ci, ts, items in prepared:
            results[ci] = [None] * len(items)  # type: ignore[list-item]
            for j, item in enumerate(items):
                test = item["test"]
                recovery = self.fault.recovery_plan(test, ci, self._golden_iters)
                if recovery is not None:
                    results[ci][j] = self._restart_with_recovery_crash(
                        item["persisted"], ci, test, recovery
                    )
                else:
                    batch_lanes.append((ci, j, item))
        if batch_lanes:
            outcomes = self._classify_lanes_batched(
                [(item["persisted"], ci) for ci, _, item in batch_lanes]
            )
            for (ci, j, _), outcome in zip(batch_lanes, outcomes):
                results[ci][j] = outcome
        for ci, ts, items in prepared:
            recs = [
                self._record_for(ci, item, outcome)
                for item, outcome in zip(items, results[ci])
            ]
            out[ci] = recs
            if on_shard is not None:
                on_shard(ci, recs)

    def payload_picklable(self) -> Tuple[bool, Optional[BaseException]]:
        """Whether this tester's campaign payload can cross a process
        boundary (apps holding jitted closures, e.g. LMTrainApp, cannot)."""
        import pickle

        try:
            pickle.dumps((self.app, self.plan, self.cache, self.fault))
            return True, None
        except Exception as e:  # noqa: BLE001 - any pickling failure
            return False, e

    def assemble_campaign(
        self,
        tests: Sequence[PlannedTest],
        shard_results: Mapping[int, List[Tuple[int, CrashRecord]]],
    ) -> CampaignResult:
        """Stitch shard results back into a :class:`CampaignResult`.

        Records are re-ordered by original test index, so the result is
        independent of shard execution order (serial, parallel, resumed).
        """
        indexed = sorted(
            (pair for recs in shard_results.values() for pair in recs),
            key=lambda pair: pair[0],
        )
        records = [r for _, r in indexed]

        # steady-state write accounting from the first test's crash window
        # (matches the historical engine, whose first simulated window was
        # the first test's)
        stats: Dict[str, float] = {}
        if tests:
            trace, _, _ = self._simulate_crash_window(tests[0].crash_iter)
            n_iters_in_window = 2
            stats = {
                "eviction_writes_per_iter": trace.eviction_writes / n_iters_in_window,
                "flush_writes_per_iter": trace.flush_writes / n_iters_in_window,
                "flushed_clean_per_iter": trace.flushed_clean_blocks / n_iters_in_window,
                "flush_ops_per_iter": trace.flush_ops / n_iters_in_window,
            }
        return CampaignResult(
            app_name=self.app.name,
            plan=self.plan,
            records=records,
            golden_iters=self._golden_iters,
            window_write_stats=stats,
        )

    def run_campaign(
        self,
        n_tests: int,
        seed: Optional[int] = None,
        n_workers: int = 1,
        store_path: Optional[str] = None,
    ) -> CampaignResult:
        """Run a crash-test campaign.

        * ``n_workers > 1`` fans the campaign's shards (one per crash
          window) out over a :class:`~concurrent.futures.ProcessPoolExecutor`.
          All randomness is pre-drawn by :meth:`plan_campaign`, so the result
          is identical for every worker count — and ``n_workers=1`` (which
          runs fully in-process) is bit-for-bit the historical serial engine.
        * ``store_path`` appends each completed shard to a JSONL
          :class:`~repro.core.campaign_store.CampaignStore`; re-running the
          same campaign against an existing (possibly truncated) store
          executes only the missing shards.
        """
        eff_seed = self.seed if seed is None else seed
        tests, shards = self.plan_shards(n_tests, eff_seed)

        store = None
        done: Dict[int, List[Tuple[int, CrashRecord]]] = {}
        if store_path is not None:
            from .campaign_store import CampaignStore

            store = CampaignStore(store_path)
            done = store.load_or_create(self._fingerprint(n_tests, eff_seed))
            done = {k: v for k, v in done.items() if k in shards}
        pending = {ci: ts for ci, ts in shards.items() if ci not in done}

        results: Dict[int, List[Tuple[int, CrashRecord]]] = dict(done)
        if n_workers > 1 and len(pending) > 1:
            # apps that hold jitted closures (e.g. LMTrainApp) cannot cross a
            # process boundary; fall back to the identical serial engine
            import warnings

            ok, err = self.payload_picklable()
            if not ok:
                warnings.warn(
                    f"{self.app.name}: campaign payload is not picklable "
                    f"({err!r}); running shards serially", RuntimeWarning,
                    stacklevel=2,
                )
                n_workers = 1
        if n_workers <= 1 or len(pending) <= 1:
            # in-process: lanes batch across windows (run_shards); completed
            # shards land in the store as their chunk finishes
            on_shard = None
            if store is not None:
                on_shard = store.append_shard
            results.update(self.run_shards(pending, on_shard=on_shard))
        else:
            with campaign_executor(
                n_workers=min(n_workers, len(pending)),
                app=self.app, cache=self.cache,
                max_extra_factor=self.max_extra_factor, fault=self.fault,
                engine=self.engine, lane_batch=self.lane_batch,
            ) as ex:
                futs = {
                    ex.submit(_shard_worker_run, "", self.plan, self.seed, ci, ts): ci
                    for ci, ts in pending.items()
                }
                for fut in as_completed(futs):
                    _, ci, recs = fut.result()
                    if store is not None:
                        store.append_shard(ci, recs)
                    results[ci] = recs

        return self.assemble_campaign(tests, results)


# ------------------------------------------------------------- worker plumbing
# Each worker process hosts a *cache of CrashTesters*, keyed by campaign: the
# pool initializer pins the shared payload (app, cache model, fault model) and
# every submitted shard names its campaign (persist plan + seed).  A single-
# campaign run uses one key; the workflow orchestrator multiplexes all of a
# workflow's campaigns over the same pool, so a worker pays each campaign's
# golden run once and then amortises it across every shard it executes.
_WORKER_HOST: Optional[
    Tuple[IterativeApp, CacheConfig, float, Optional[FaultModel], Optional[str], Optional[int]]
] = None
_WORKER_TESTERS: "OrderedDict[str, Tuple[PersistPlan, int, CrashTester]]" = None  # type: ignore[assignment]
#: LRU bound on coexisting per-campaign testers in one worker: each pins a
#: full golden trajectory, so an unbounded cache would multiply resident
#: memory by the campaign count (isolated-mode workflows run W+2 campaigns).
#: Evicting only costs a deterministic golden re-run if that campaign's
#: shards come back around.
_WORKER_TESTER_CAP = 8


def _shard_worker_init(
    app: IterativeApp,
    cache: CacheConfig,
    max_extra_factor: float,
    fault: Optional[FaultModel] = None,
    engine: Optional[str] = None,
    lane_batch: Optional[int] = None,
) -> None:
    global _WORKER_HOST, _WORKER_TESTERS
    from collections import OrderedDict

    _WORKER_HOST = (app, cache, max_extra_factor, fault, engine, lane_batch)
    _WORKER_TESTERS = OrderedDict()


def _shard_worker_run(
    campaign_key: str,
    plan: PersistPlan,
    seed: int,
    crash_iter: int,
    tests: Sequence[PlannedTest],
) -> Tuple[str, int, List[Tuple[int, CrashRecord]]]:
    assert _WORKER_HOST is not None, "worker used before initialization"
    cached = _WORKER_TESTERS.get(campaign_key)
    # the cache is keyed by campaign key but *validated* against the plan and
    # seed each shard carries: a rebound key must never reuse a stale tester
    if cached is not None and (cached[0], cached[1]) == (plan, seed):
        tester = cached[2]
    else:
        app, cache, max_extra_factor, fault, engine, lane_batch = _WORKER_HOST
        tester = CrashTester(
            app, plan, cache, seed=seed,
            max_extra_factor=max_extra_factor, fault=fault, engine=engine,
            lane_batch=lane_batch,
        )
        _WORKER_TESTERS[campaign_key] = (plan, seed, tester)
        while len(_WORKER_TESTERS) > _WORKER_TESTER_CAP:
            _WORKER_TESTERS.popitem(last=False)
    _WORKER_TESTERS.move_to_end(campaign_key)
    return campaign_key, crash_iter, tester.run_window_tests(crash_iter, tests)


def campaign_executor(
    n_workers: int,
    app: IterativeApp,
    cache: CacheConfig,
    max_extra_factor: float = 2.0,
    fault: Optional[FaultModel] = None,
    engine: Optional[str] = None,
    lane_batch: Optional[int] = None,
) -> ProcessPoolExecutor:
    """A shard worker pool bound to one (app, cache, fault) payload.

    Submit shards with ``ex.submit(_shard_worker_run, key, plan, seed, ci,
    tests)`` — campaigns with distinct keys coexist on the same pool.
    """
    import multiprocessing as mp

    # spawn, not fork: jax is multithreaded and forked children
    # deadlock (REPRO_MP_START exists for non-jax substrates only)
    ctx = mp.get_context(os.environ.get("REPRO_MP_START", "spawn"))
    return ProcessPoolExecutor(
        max_workers=n_workers,
        mp_context=ctx,
        initializer=_shard_worker_init,
        initargs=(app, cache, max_extra_factor, fault, engine, lane_batch),
    )
