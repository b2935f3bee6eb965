# Port copy of repro/core/workflow.py, unchanged apart from this header; its
# lazy import of analysis.classify resolves to the port's static analyzer.
"""The four-step EasyCrash workflow (paper §5.3).

Step 1 — run a crash-test campaign without persistence, collecting per-object
inconsistency rates and recompute outcomes.
Step 2 — Spearman selection of critical data objects.
Step 3 — run a second campaign persisting the critical objects at every
region (this also yields c_k^max per region), then solve the knapsack for
critical code regions and flush frequencies under (t_s, tau).
Step 4 — production: run with the resulting :class:`PersistPlan`.

``run_workflow`` executes steps 1–3 and returns everything a production run
(or the benchmarks reproducing the paper's figures) needs.

Orchestration: a workflow is not one campaign but W+2 of them (baseline,
persist-everywhere, and — in ``"isolated"`` mode — one per region).  The
default ``scheduler="shared"`` flattens all of them into a single task graph
of (campaign, shard) units executed on **one** shared process pool: the only
true barrier is after the baseline campaign (step 2's Spearman selection
decides what the remaining campaigns persist); past it, every shard of every
remaining campaign interleaves freely.  ``scheduler="serial"`` is the
historical engine (each campaign back-to-back with its own pool); results
are bit-for-bit identical between the two, at every worker count.

``store_path=`` appends each completed shard to a
:class:`~repro.core.campaign_store.WorkflowStore`; a killed ``run_workflow``
resumes from it and executes only the shards that never landed.
"""
from __future__ import annotations

import dataclasses
import warnings
from concurrent.futures import as_completed
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .adaptive import (
    AdaptiveReport,
    RegionEvidence,
    SequentialConfig,
    StaticPriorSampler,
    final_rate_interval,
    selection_invariant,
    shard_rounds,
)
from .cache_sim import CacheConfig
from .crash_tester import (
    CampaignResult,
    CrashRecord,
    CrashTester,
    PersistPlan,
    PlannedTest,
    _shard_worker_run,
    campaign_executor,
)
from .efficiency import SystemConfig, tau_threshold
from .faults import FaultModel
from .regions import IterativeApp
from .selection import (
    ObjectScore,
    RegionSelection,
    critical_objects,
    select_objects,
    select_regions,
    select_regions_from_gains,
)

#: bump when the workflow-store line layout changes
WORKFLOW_STORE_VERSION = 1


@dataclass(frozen=True)
class WorkflowConfig:
    """Everything :func:`run_workflow` needs besides the app, in one frozen,
    validated object.

    The fields are exactly the historical keyword arguments; a config built
    with all defaults reproduces the historical default workflow bit for
    bit.  ``replace(**overrides)`` derives a variant (the idiom for sweeps);
    :meth:`spec` is the single serialization point — artifact and
    resume-store fingerprints are computed from it, never from ad-hoc field
    plumbing.

    ``shard_callback`` is runtime plumbing (progress reporting, crash
    injection in tests), not workflow identity: it is excluded from
    :meth:`spec`, so attaching one cannot invalidate a resume store.
    """

    n_tests: int = 200
    cache: CacheConfig = CacheConfig()  # frozen dataclass: safe shared default
    system: Optional[SystemConfig] = None
    t_s: float = 0.03
    p_threshold: float = 0.01
    freq_options: Tuple[int, ...] = (1, 2, 4, 8)
    seed: int = 0
    region_measure: str = "isolated"
    n_workers: int = 1
    fault_model: Optional[FaultModel] = None
    scheduler: str = "shared"
    store_path: Optional[str] = None
    shard_callback: Optional[Callable[[str, int], None]] = None
    engine: Optional[str] = None
    #: vec-engine lane-bucket cap (lanes stacked per batched-recompute
    #: dispatch); ``None`` defers to the ``REPRO_LANE_BATCH`` environment
    #: variable.  Execution plumbing like ``engine``: results are identical
    #: at any value, so it is excluded from :meth:`spec`.
    lane_batch: Optional[int] = None
    #: where the persist plan comes from: ``"measured"`` (the paper's W+2
    #: campaign), ``"static"`` (the jaxpr dataflow prediction, no campaigns
    #: at all), ``"static+verify"`` (campaigns only for the regions the
    #: static classification is uncertain about; confident decisions are
    #: taken as-is), or ``"adaptive"`` (every region campaigned, but
    #: importance-sampled from the static priors and early-stopped the
    #: moment the knapsack decision is settled — see
    #: :mod:`repro.core.adaptive`)
    plan_source: str = "measured"
    #: sequential-stopping knobs for the adaptive scheduler.  ``None`` with
    #: ``plan_source="adaptive"`` resolves to ``SequentialConfig()``; with
    #: ``"static+verify"`` it turns the surviving (uncertain-region)
    #: campaigns adaptive too; with any other plan_source it is an error.
    stopping: Optional[SequentialConfig] = None

    def __post_init__(self):
        object.__setattr__(self, "freq_options",
                           tuple(int(x) for x in self.freq_options))
        if self.n_tests < 1:
            raise ValueError(f"n_tests must be >= 1, got {self.n_tests}")
        if self.region_measure not in ("paper", "isolated"):
            raise ValueError(f"unknown region_measure {self.region_measure!r}")
        if self.scheduler not in ("shared", "serial"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.scheduler != "shared" and (
            self.store_path is not None or self.shard_callback is not None
        ):
            raise ValueError(
                "store_path/shard_callback require the 'shared' scheduler"
            )
        if self.plan_source not in ("measured", "static", "static+verify", "adaptive"):
            raise ValueError(f"unknown plan_source {self.plan_source!r}")
        if self.plan_source == "static" and self.store_path is not None:
            raise ValueError(
                "plan_source='static' runs no campaigns; store_path is "
                "meaningless there"
            )
        if self.plan_source in ("static+verify", "adaptive") and self.region_measure != "isolated":
            raise ValueError(
                f"plan_source={self.plan_source!r} works on per-region campaigns and "
                f"requires region_measure='isolated'"
            )
        if self.stopping is not None and not isinstance(self.stopping, SequentialConfig):
            raise ValueError(
                f"stopping must be a SequentialConfig, got "
                f"{type(self.stopping).__name__}"
            )
        if self.stopping is not None and self.plan_source not in ("adaptive", "static+verify"):
            raise ValueError(
                "stopping requires plan_source='adaptive' or 'static+verify' "
                f"(got {self.plan_source!r})"
            )
        if self.plan_source == "adaptive" and self.scheduler != "shared":
            raise ValueError(
                "plan_source='adaptive' executes deterministic shard rounds "
                "and requires the 'shared' scheduler"
            )
        if (
            self.plan_source == "static+verify"
            and self.stopping is not None
            and self.scheduler != "shared"
        ):
            raise ValueError("stopping requires the 'shared' scheduler")

    def replace(self, **overrides) -> "WorkflowConfig":
        """A copy with the given fields overridden (re-validated)."""
        return dataclasses.replace(self, **overrides)

    def resolved_system(self) -> SystemConfig:
        return self.system or SystemConfig(mtbf=12 * 3600.0, t_chk=320.0)

    def adaptive_mode(self) -> bool:
        """Whether region campaigns run under the sequential scheduler."""
        return self.plan_source == "adaptive" or (
            self.plan_source == "static+verify" and self.stopping is not None
        )

    def resolved_stopping(self) -> SequentialConfig:
        return self.stopping if self.stopping is not None else SequentialConfig()

    def spec(self, app: IterativeApp, baseline_tester: CrashTester) -> Dict[str, object]:
        """Workflow identity (JSON-round-trip safe) for stores + artifacts.

        Only fields that change campaign *results* participate; execution
        plumbing (n_workers, scheduler, store_path, shard_callback, engine,
        lane_batch — all bit-for-bit invariant by contract) does not.
        """
        from .faults import PowerFail

        fault = self.fault_model if self.fault_model is not None else PowerFail()
        d = {
            "workflow_store_version": WORKFLOW_STORE_VERSION,
            "app": app.name,
            "state_digest": baseline_tester._state_digest(),
            "n_tests": int(self.n_tests),
            "seed": int(self.seed),
            "region_measure": str(self.region_measure),
            "t_s": float(self.t_s),
            "p_threshold": float(self.p_threshold),
            "freq_options": [int(x) for x in self.freq_options],
            "cache_blocks": int(self.cache.capacity_blocks),
            "block_bytes": int(self.cache.block_bytes),
            "fault": fault.spec(),
        }
        # only when non-default, so every historical fingerprint is unchanged
        if self.plan_source != "measured":
            d["plan_source"] = str(self.plan_source)
        if self.adaptive_mode():
            # the stopping rule changes which shards execute, so it is
            # workflow identity (resolved, so "adaptive" with stopping=None
            # and with an explicit default SequentialConfig() are the same
            # workflow — they are)
            d["stopping"] = self.resolved_stopping().spec()
        return d


@dataclass(frozen=True)
class CampaignSpec:
    """One campaign of a workflow's task graph, identified by ``key``
    (``"baseline"``, ``"best"``, ``"region:<k>"``).

    ``sampler`` (optional) importance-samples the campaign's crash points
    at planning time (:class:`~repro.core.adaptive.StaticPriorSampler`);
    it participates in the campaign's store fingerprint.
    """

    key: str
    plan: PersistPlan
    seed: int
    n_tests: int
    sampler: Optional[StaticPriorSampler] = None


@dataclass(frozen=True)
class RoundsResult:
    """What :meth:`WorkflowOrchestrator.run_rounds` executed.

    ``campaigns`` hold each campaign's result over the *executed prefix*
    only; ``planned``/``executed`` are the full pre-drawn test lists and the
    tests whose rounds actually ran.
    """

    campaigns: Dict[str, CampaignResult]
    planned: Dict[str, List[PlannedTest]]
    executed: Dict[str, List[PlannedTest]]
    rounds_executed: int
    rounds_total: int
    stopped_early: bool

    def spec(self) -> Dict[str, object]:
        return {
            "rounds_executed": self.rounds_executed,
            "rounds_total": self.rounds_total,
            "stopped_early": self.stopped_early,
            "campaigns": {k: c.spec() for k, c in sorted(self.campaigns.items())},
            "planned": {k: len(v) for k, v in sorted(self.planned.items())},
            "executed": {k: len(v) for k, v in sorted(self.executed.items())},
        }


class _PerCampaignRunner:
    """The historical scheduler: each campaign runs to completion on its own
    pool (``CrashTester.run_campaign``), strictly in submission order."""

    def __init__(self, app, cache, fault, n_workers, max_extra_factor=2.0, engine=None,
                 lane_batch=None):
        self.app, self.cache, self.fault = app, cache, fault
        self.n_workers = n_workers
        self.max_extra_factor = max_extra_factor
        self.engine = engine
        self.lane_batch = lane_batch

    def run(self, specs: Sequence[CampaignSpec]) -> Dict[str, CampaignResult]:
        out: Dict[str, CampaignResult] = {}
        for s in specs:
            out[s.key] = CrashTester(
                self.app, s.plan, self.cache, seed=s.seed,
                max_extra_factor=self.max_extra_factor, fault=self.fault,
                engine=self.engine, lane_batch=self.lane_batch,
            ).run_campaign(s.n_tests, n_workers=self.n_workers)
        return out

    def close(self) -> None:
        pass


class WorkflowOrchestrator:
    """Shared-pool scheduler for a workflow's (campaign, shard) task graph.

    * One :class:`~concurrent.futures.ProcessPoolExecutor` for the whole
      workflow: workers are spawned once (not once per campaign) and each
      worker hosts one :class:`CrashTester` per campaign it has seen, so
      per-campaign golden runs are paid at most once per worker.
    * Shards of different campaigns in the same :meth:`run` batch interleave
      freely — a straggler window of one region's campaign no longer blocks
      every other region's campaign from starting.
    * All campaign randomness is pre-drawn at planning time, so scheduling
      (order, worker count, resume) cannot change any result.
    * With a :class:`~repro.core.campaign_store.WorkflowStore` attached,
      completed shards are durably appended as they land and a resumed
      workflow executes only the missing ones.
    """

    def __init__(
        self,
        app: IterativeApp,
        cache: CacheConfig,
        fault: Optional[FaultModel],
        n_workers: int = 1,
        store=None,
        shard_callback: Optional[Callable[[str, int], None]] = None,
        max_extra_factor: float = 2.0,
        engine: Optional[str] = None,
        lane_batch: Optional[int] = None,
    ):
        self.app, self.cache, self.fault = app, cache, fault
        self.n_workers = n_workers
        self.store = store
        self.shard_callback = shard_callback
        self.max_extra_factor = max_extra_factor
        self.engine = engine
        self.lane_batch = lane_batch
        self._testers: Dict[str, Tuple[CampaignSpec, CrashTester]] = {}
        self._ex = None
        self._pickle_checked = False

    # ------------------------------------------------------------- plumbing
    def tester(self, spec: CampaignSpec) -> CrashTester:
        """The parent-side tester of one campaign (planning + assembly).

        A campaign key names one identity for the orchestrator's lifetime:
        parent and worker caches are keyed by it, so silently rebinding a
        key to a different plan/seed would hand back results computed under
        the old campaign.
        """
        cached = self._testers.get(spec.key)
        if cached is not None:
            prev, t = cached
            if (prev.plan, prev.seed, prev.sampler) != (spec.plan, spec.seed, spec.sampler):
                raise ValueError(
                    f"campaign key {spec.key!r} already bound to a different "
                    f"plan/seed/sampler in this orchestrator; use a fresh key"
                )
            return t
        t = CrashTester(
            self.app, spec.plan, self.cache, seed=spec.seed,
            max_extra_factor=self.max_extra_factor, fault=self.fault,
            engine=self.engine, sampler=spec.sampler,
            lane_batch=self.lane_batch,
        )
        self._testers[spec.key] = (spec, t)
        return t

    def _pool(self):
        if self._ex is None:
            self._ex = campaign_executor(
                n_workers=self.n_workers, app=self.app, cache=self.cache,
                max_extra_factor=self.max_extra_factor, fault=self.fault,
                engine=self.engine, lane_batch=self.lane_batch,
            )
        return self._ex

    def _use_pool(self, n_pending: int) -> bool:
        if self.n_workers <= 1 or n_pending <= 1:
            return False
        if self._ex is not None:
            return True
        if not self._pickle_checked:
            self._pickle_checked = True
            ok, err = CrashTester(
                self.app, PersistPlan.none(), self.cache, fault=self.fault
            ).payload_picklable()
            if not ok:
                import warnings

                warnings.warn(
                    f"{self.app.name}: workflow payload is not picklable "
                    f"({err!r}); running shards serially", RuntimeWarning,
                    stacklevel=3,
                )
                self.n_workers = 1
        return self.n_workers > 1

    # ------------------------------------------------------------ execution
    def run(self, specs: Sequence[CampaignSpec]) -> Dict[str, CampaignResult]:
        """Execute a batch of campaigns, interleaving their shards."""
        planned: Dict[str, Tuple[List[PlannedTest], Dict[int, List[PlannedTest]]]] = {}
        results: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        pending: List[Tuple[CampaignSpec, int, List[PlannedTest]]] = []
        for spec in specs:
            planned[spec.key] = self.tester(spec).plan_shards(spec.n_tests, spec.seed)
        stored: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        if self.store is not None:
            # one store pass registers/validates the whole batch
            stored = self.store.register_campaigns({
                spec.key: self.tester(spec)._fingerprint(spec.n_tests, spec.seed)
                for spec in specs
            })
        for spec in specs:
            tests, shards = planned[spec.key]
            done = {
                k: v for k, v in stored.get(spec.key, {}).items() if k in shards
            }
            results[spec.key] = done
            for ci, ts in shards.items():
                if ci not in done:
                    pending.append((spec, ci, ts))

        self._execute_pending(pending, results)

        out = {
            key: self._testers[key][1].assemble_campaign(planned[key][0], results[key])
            for key in planned
        }
        for key in planned:
            # the campaign is assembled; don't keep W+2 golden trajectories
            # pinned in the parent for the rest of the workflow
            self._testers[key][1].release_caches()
        return out

    def _execute_pending(
        self,
        pending: Sequence[Tuple[CampaignSpec, int, List[PlannedTest]]],
        results: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]],
    ) -> None:
        """Execute pending (campaign, shard) units; land each as it finishes."""
        if self._use_pool(len(pending)):
            ex = self._pool()
            futs = {
                ex.submit(_shard_worker_run, spec.key, spec.plan, spec.seed, ci, ts):
                    spec.key
                for spec, ci, ts in pending
            }
            for fut in as_completed(futs):
                key, ci, recs = fut.result()
                self._land(key, ci, recs, results)
        else:
            # in-process: hand each campaign's pending shards to run_shards,
            # which batches recompute lanes across windows on the vec engine;
            # _land fires per shard exactly as the per-shard loop did
            by_spec: Dict[str, Tuple[CampaignSpec, Dict[int, List[PlannedTest]]]] = {}
            for spec, ci, ts in pending:
                by_spec.setdefault(spec.key, (spec, {}))[1][ci] = ts
            for key, (spec, shard_map) in by_spec.items():
                self.tester(spec).run_shards(
                    shard_map,
                    on_shard=lambda ci, recs, _k=key: self._land(_k, ci, recs, results),
                )

    def run_rounds(
        self,
        specs: Sequence[CampaignSpec],
        round_tests: int,
        min_rounds: int,
        should_stop,
    ) -> "RoundsResult":
        """Execute campaigns in deterministic barrier rounds with early stop.

        Each campaign's shards are partitioned by
        :func:`~repro.core.adaptive.shard_rounds` (whole shards, planned-test
        order, ~``round_tests`` tests per round) — a pure function of the
        plan.  Round *r* of every campaign executes together (pool or
        in-process, identical results), lands durably, and then
        ``should_stop(partial, executed, planned)`` is evaluated on the
        completed prefix: ``partial`` maps campaign key to the
        :class:`CampaignResult` over the executed tests so far, ``executed``
        / ``planned`` map keys to test lists.  Because the executed set
        after each round — and therefore the stop round — depends only on
        the completed-round prefix, worker count and kill/resume cannot
        change any result bit.  Stored shards beyond the stop round (never
        produced by this scheduler, but a store is append-only) are ignored
        deterministically.
        """
        planned: Dict[str, Tuple[List[PlannedTest], Dict[int, List[PlannedTest]]]] = {}
        for spec in specs:
            planned[spec.key] = self.tester(spec).plan_shards(spec.n_tests, spec.seed)
        stored: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        if self.store is not None:
            stored = self.store.register_campaigns({
                spec.key: self.tester(spec)._fingerprint(spec.n_tests, spec.seed)
                for spec in specs
            })
        rounds_by_key = {
            spec.key: shard_rounds(planned[spec.key][0], planned[spec.key][1], round_tests)
            for spec in specs
        }
        rounds_total = max((len(r) for r in rounds_by_key.values()), default=0)

        results: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {
            spec.key: {} for spec in specs
        }
        executed: Dict[str, List[PlannedTest]] = {spec.key: [] for spec in specs}
        planned_tests = {key: planned[key][0] for key in planned}
        stopped_early = False
        rounds_executed = 0
        for r in range(rounds_total):
            pending: List[Tuple[CampaignSpec, int, List[PlannedTest]]] = []
            for spec in specs:
                rounds_k = rounds_by_key[spec.key]
                if r >= len(rounds_k):
                    continue
                shards = planned[spec.key][1]
                for ci in rounds_k[r]:
                    executed[spec.key].extend(shards[ci])
                    done = stored.get(spec.key, {}).get(ci)
                    if done is not None:
                        results[spec.key][ci] = done
                    else:
                        pending.append((spec, ci, shards[ci]))
            self._execute_pending(pending, results)
            rounds_executed = r + 1
            if rounds_executed >= min_rounds and rounds_executed < rounds_total:
                partial = self._assemble_prefix(specs, executed, results)
                if should_stop(partial, executed, planned_tests):
                    stopped_early = True
                    break

        campaigns = self._assemble_prefix(specs, executed, results)
        for spec in specs:
            self._testers[spec.key][1].release_caches()
        return RoundsResult(
            campaigns=campaigns,
            planned=planned_tests,
            executed=executed,
            rounds_executed=rounds_executed,
            rounds_total=rounds_total,
            stopped_early=stopped_early,
        )

    def _assemble_prefix(
        self,
        specs: Sequence[CampaignSpec],
        executed: Mapping[str, List[PlannedTest]],
        results: Mapping[str, Dict[int, List[Tuple[int, CrashRecord]]]],
    ) -> Dict[str, CampaignResult]:
        return {
            spec.key: self._testers[spec.key][1].assemble_campaign(
                sorted(executed[spec.key], key=lambda t: t.index),
                results[spec.key],
            )
            for spec in specs
        }

    def _land(self, key, ci, recs, results) -> None:
        if self.store is not None:
            self.store.append_shard(key, ci, recs)
        results[key][ci] = recs
        if self.shard_callback is not None:
            self.shard_callback(key, ci)

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown()
            self._ex = None


@dataclass(frozen=True)
class WorkflowResult:
    app_name: str
    baseline_campaign: Optional[CampaignResult]  # step 1 (None for plan_source="static")
    object_scores: List[ObjectScore]           # step 2
    critical: Tuple[str, ...]
    best_campaign: Optional[CampaignResult]    # step 3 input (None for "static")
    region_selection: RegionSelection
    plan: PersistPlan                          # step 4 product
    tau: float
    t_s: float
    #: provenance + cost of the plan: which source produced it and how many
    #: crash tests the workflow actually executed to get there
    plan_source: str = "measured"
    tests_executed: int = 0
    #: the :class:`repro.analysis.classify.StaticPlan` evidence, when a
    #: static plan_source was used (duck-typed: core does not import analysis)
    static_plan: Optional[object] = None
    #: the sequential scheduler's stopping decision + per-region evidence,
    #: when the workflow ran adaptively
    adaptive: Optional[AdaptiveReport] = None

    def summary(self) -> Dict[str, float]:
        nan = float("nan")
        return {
            "baseline_recomputability": (
                self.baseline_campaign.recomputability
                if self.baseline_campaign is not None else nan),
            "best_recomputability": (
                self.best_campaign.recomputability
                if self.best_campaign is not None else nan),
            "expected_recomputability": self.region_selection.expected_recomputability,
            "planned_overhead": self.region_selection.total_overhead,
            "n_critical_objects": float(len(self.critical)),
            "n_critical_regions": float(len(self.region_selection.choices)),
            "tau": self.tau,
            "tests_executed": float(self.tests_executed),
        }

    def spec(self) -> Dict[str, object]:
        """JSON-round-trip-safe identity of the workflow outcome."""
        def _f(x: float):
            x = float(x)
            return x if x == x and abs(x) != float("inf") else None

        return {
            "app": self.app_name,
            "plan_source": self.plan_source,
            "critical": list(self.critical),
            "plan": {
                "objects": list(self.plan.objects),
                "region_freq": sorted(
                    [int(k), int(v)] for k, v in self.plan.region_freq.items()
                ),
            },
            "tau": _f(self.tau),
            "t_s": _f(self.t_s),
            "tests_executed": int(self.tests_executed),
            "summary": {k: _f(v) for k, v in self.summary().items()},
            # only when the workflow ran adaptively: historical specs unchanged
            **({"adaptive": self.adaptive.to_payload()}
               if self.adaptive is not None else {}),
        }

    def recompute_profile(self, which: str = "best", fault: Optional[FaultModel] = None):
        """The workflow's measured :class:`~repro.core.sysim.RecomputeProfile`
        — S1–S4 rates plus the extra-recompute-iteration histogram — for the
        system-efficiency simulator.

        ``which`` picks the measured campaign: ``"best"`` (persist
        everywhere — the upper bound the knapsack plan approaches) or
        ``"baseline"`` (no EasyCrash flushes at all).  ``fault`` must name
        the model the workflow ran under (``run_workflow(fault_model=)``);
        ``None`` is the default clean power failure.
        """
        from .sysim import RecomputeProfile

        campaigns = {"best": self.best_campaign, "baseline": self.baseline_campaign}
        if which not in campaigns:
            raise ValueError(f"which={which!r}, expected one of {sorted(campaigns)}")
        if campaigns[which] is None:
            raise ValueError(
                f"workflow ran with plan_source={self.plan_source!r}: no "
                f"{which!r} campaign was measured"
            )
        return RecomputeProfile.from_campaign(campaigns[which], fault=fault)


def estimate_region_overheads(
    app: IterativeApp,
    objects: Sequence[str],
    flush_cost_per_block: float = 0.1,
    block_bytes: int = 64,
) -> List[float]:
    """Estimate l_k: cost of flushing the selected objects at region k, as a
    fraction of one iteration's execution time.

    The paper estimates l_k from the measured cost of flushing one cache
    block times the object block count, deliberately assuming every block is
    resident+dirty (an overestimate, then doubled for reload cost — kept
    here).  Execution time per region is proxied by its access volume times
    its declared cost weight; ``flush_cost_per_block`` calibrates a CLWB
    write-back against one region "access" (a region access implies FLOPs,
    a flush is a pure streaming store — the paper measures ~0.03 s per
    persist op against seconds-long iterations).
    """
    state = app.init(0)
    regs = app.regions()
    region_time = []
    for r in regs:
        vol = sum(
            max(1, -(-np.asarray(state[o]).nbytes // block_bytes))
            for o in tuple(r.reads) + tuple(r.writes)
            if o in state
        )
        region_time.append(max(1.0, vol) * r.cost)
    total_time = sum(region_time)
    flush_blocks = sum(
        max(1, -(-np.asarray(state[o]).nbytes // block_bytes))
        for o in objects
        if o in state
    )
    # x2: CLFLUSH-style invalidation forces reloads (paper §5.2 "How to use")
    l_once = 2.0 * flush_cost_per_block * flush_blocks
    return [l_once / total_time for _ in regs]


def region_time_fractions(app: IterativeApp, block_bytes: int = 64) -> List[float]:
    """a_k: execution-time fraction per region (access-volume x cost proxy)."""
    state = app.init(0)
    regs = app.regions()
    t = []
    for r in regs:
        vol = sum(
            max(1, -(-np.asarray(state[o]).nbytes // block_bytes))
            for o in tuple(r.reads) + tuple(r.writes)
            if o in state
        )
        t.append(max(1.0, vol) * r.cost)
    s = sum(t)
    return [x / s for x in t]


def workflow_fingerprint(
    app: IterativeApp,
    baseline_tester: CrashTester,
    n_tests: int,
    seed: int,
    cache: CacheConfig,
    region_measure: str,
    t_s: float,
    p_threshold: float,
    freq_options: Sequence[int],
    fault: FaultModel,
) -> Dict[str, object]:
    """Identity of a workflow for the resume store (JSON-round-trip safe).

    Thin compatibility wrapper over :meth:`WorkflowConfig.spec` — the one
    serialization point for workflow identity.
    """
    cfg = WorkflowConfig(
        n_tests=n_tests, cache=cache, t_s=t_s, p_threshold=p_threshold,
        freq_options=tuple(freq_options), seed=seed,
        region_measure=region_measure, fault_model=fault,
    )
    return cfg.spec(app, baseline_tester)


def run_workflow(app: IterativeApp, config=None, /, **kwargs) -> WorkflowResult:
    """Steps 1–3.

    Primary signature: ``run_workflow(app, WorkflowConfig(...))``; extra
    keyword arguments are applied as overrides via
    :meth:`WorkflowConfig.replace`.  The historical 14-keyword form
    (``run_workflow(app, n_tests=..., cache=..., ...)``) still works as a
    deprecation shim that builds the same config — results are identical.

    ``n_workers`` workers execute the workflow's crash-test shards; results
    are identical for every worker count.

    ``engine`` selects the campaign hot path (``"vec"`` | ``"ref"``, see
    :class:`~repro.core.crash_tester.CrashTester`); results are bit-for-bit
    identical between engines.  The workflow's campaigns share simulated
    crash windows through the process-wide
    :class:`~repro.core.trace_cache.WindowTraceCache` — the baseline and
    per-region campaigns reuse each other's window payloads, and replaying
    the same plan (robustness matrix, artifact replay) reuses whole traces.

    ``scheduler`` selects how the workflow's W+2 campaigns are executed:

    * ``"shared"`` (default) — the :class:`WorkflowOrchestrator`: one shared
      process pool for every campaign, shards of independent campaigns
      interleaved;
    * ``"serial"`` — the historical path: each campaign back-to-back through
      :meth:`~repro.core.crash_tester.CrashTester.run_campaign`, each with
      its own pool.  Bit-for-bit identical results, slower wall-clock.

    ``store_path`` (``"shared"`` scheduler only) appends every completed
    shard to a :class:`~repro.core.campaign_store.WorkflowStore`: kill the
    workflow at any point, re-run the same call, and only the missing shards
    execute.  ``shard_callback(campaign_key, shard_id)`` fires after each
    executed shard has been durably stored (progress reporting, crash
    injection in tests).

    ``fault_model`` selects what a "crash" is for every campaign the
    workflow runs (:mod:`repro.core.faults`); ``None`` is the paper's clean
    power failure.  Characterizing under one model and deploying the plan
    under another is exactly the scenario-robustness question the fault
    sweep in ``benchmarks/bench_recomputability.py`` measures.

    ``region_measure`` selects how c_k^max is estimated:

    * ``"paper"`` — one persist-everywhere campaign, per-region grouping
      (§5.2's shortcut; cheap but mis-attributes when flushing at region j
      changes the image seen by crashes in region k);
    * ``"isolated"`` — one small campaign per region with flushes at that
      region only (the paper's own Fig 4b methodology).  Costs W extra
      campaigns but measures the true marginal gain of each region.
    """
    if isinstance(config, WorkflowConfig):
        cfg = config.replace(**kwargs) if kwargs else config
    elif config is None:
        if kwargs:
            # stacklevel=2 attributes the warning to run_workflow's caller
            # (the site that must migrate), not this shim; it fires before
            # WorkflowConfig validation so even a call with bad kwargs tells
            # the caller to migrate.  tests/test_workflow_config.py pins the
            # warning's origin.
            warnings.warn(
                "run_workflow(app, n_tests=..., ...) keyword form is "
                "deprecated; pass run_workflow(app, WorkflowConfig(...))",
                DeprecationWarning, stacklevel=2,
            )
        cfg = WorkflowConfig(**kwargs)
    elif isinstance(config, int):
        # legacy positional n_tests
        warnings.warn(
            "run_workflow(app, n_tests) positional form is deprecated; "
            "pass run_workflow(app, WorkflowConfig(n_tests=...))",
            DeprecationWarning, stacklevel=2,
        )
        cfg = WorkflowConfig(n_tests=config, **kwargs)
    else:
        raise TypeError(
            f"config must be a WorkflowConfig (or legacy kwargs), got "
            f"{type(config).__name__}"
        )

    n_tests, cache, seed = cfg.n_tests, cfg.cache, cfg.seed
    t_s, p_threshold, freq_options = cfg.t_s, cfg.p_threshold, cfg.freq_options
    region_measure, fault_model = cfg.region_measure, cfg.fault_model
    tau = tau_threshold(cfg.resolved_system(), t_s=t_s)

    static_plan = None
    if cfg.plan_source != "measured":
        # lazy import: core must not import analysis at module load
        from ..analysis.classify import analyze_app

        static_plan = analyze_app(app, cache=cache, seed=seed)

    if cfg.plan_source == "static":
        # no campaigns at all: the dataflow classification is the plan
        sel = static_plan.region_selection(
            t_s=t_s, tau=tau, freq_options=freq_options
        )
        crit = static_plan.persist_objects()
        plan = PersistPlan(objects=crit, region_freq=sel.plan_freqs())
        return WorkflowResult(
            app_name=app.name,
            baseline_campaign=None,
            object_scores=[],
            critical=crit,
            best_campaign=None,
            region_selection=sel,
            plan=plan,
            tau=tau,
            t_s=t_s,
            plan_source="static",
            tests_executed=0,
            static_plan=static_plan,
        )

    if cfg.scheduler == "serial":
        runner = _PerCampaignRunner(
            app, cache, fault_model, cfg.n_workers, engine=cfg.engine,
            lane_batch=cfg.lane_batch,
        )
    else:
        store = None
        runner = WorkflowOrchestrator(
            app, cache, fault_model, cfg.n_workers,
            shard_callback=cfg.shard_callback, engine=cfg.engine,
            lane_batch=cfg.lane_batch,
        )
        if cfg.store_path is not None:
            from .campaign_store import WorkflowStore

            store = WorkflowStore(cfg.store_path)
            store.load_or_create(cfg.spec(
                app,
                runner.tester(CampaignSpec("baseline", PersistPlan.none(), seed, n_tests)),
            ))
            runner.store = store

    try:
        # Step 1: baseline campaign (NVM holds whatever eviction left there).
        # This is the task graph's one true barrier: step 2's selection (and
        # therefore every later campaign's persist plan) depends on it.
        baseline = runner.run(
            [CampaignSpec("baseline", PersistPlan.none(), seed, n_tests)]
        )["baseline"]

        # Step 2: Spearman object selection.  The loop iterator is excluded:
        # it is *always* persisted (paper fn. 3), never subject to selection.
        sel_candidates = [c for c in app.candidates if c != app.iterator_object]
        scores = select_objects(baseline, sel_candidates, p_threshold)
        crit = critical_objects(scores)
        if not crit:
            # fall back to the most negatively-correlated object: persisting
            # nothing would make step 3 vacuous (paper always persists >=1)
            ranked = sorted(
                (s for s in scores if not np.isnan(s.rs)), key=lambda s: s.rs
            )
            crit = (ranked[0].name,) if ranked else tuple(sel_candidates[:1])

        # Step 3: measure per-region recomputability with persistence, then
        # solve the knapsack.  Every remaining campaign is independent, so
        # the shared scheduler flattens them into one interleaved shard batch.
        n_regions = len(app.regions())
        a = region_time_fractions(app, cache.block_bytes)
        l = estimate_region_overheads(app, crit, block_bytes=cache.block_bytes)
        adaptive_mode = cfg.adaptive_mode()
        stopping = cfg.resolved_stopping() if adaptive_mode else None
        sampler = None
        region_ids: List[int] = []
        region_specs: List[CampaignSpec] = []
        per_region_n = max(30, n_tests // 2)
        if region_measure == "isolated":
            # which regions get a measurement campaign: "adaptive" campaigns
            # all of them (cheaply — IS + early stop); static+verify only the
            # regions whose static classification is uncertain; "measured"
            # all of them, brute force.  Seeds stay seed+2+k so any campaign
            # that does run draws the same stream as the full workflow's.
            if static_plan is not None and cfg.plan_source == "static+verify":
                region_ids = static_plan.uncertain_regions()
            else:
                region_ids = list(range(n_regions))
            if adaptive_mode and stopping.sampler_bias > 0 and region_ids:
                sampler = StaticPriorSampler(
                    static_plan.window_confidences(), bias=stopping.sampler_bias
                )
            region_specs = [
                CampaignSpec(
                    f"region:{k}",
                    PersistPlan(objects=crit, region_freq={k: 1}),
                    seed + 2 + k,
                    per_region_n,
                    sampler=sampler,
                )
                for k in region_ids
            ]
        specs = [CampaignSpec("best", PersistPlan.best(crit, app), seed + 1, n_tests)]
        adaptive_report = None
        if adaptive_mode:
            c_base = baseline.recomputability
            overheads = {k: l[k] for k in range(n_regions)}
            decisions = {r.index: r.decision for r in static_plan.regions}
            campaigned = set(region_ids)
            best_in_rounds = cfg.plan_source == "adaptive"
            if best_in_rounds:
                # Pure adaptive mode: the knapsack's gains are region-vs-
                # baseline, so the persist-everything reference never feeds
                # the decision.  Its remaining uncertainty therefore cannot
                # change the plan — the stopping criterion applies to it
                # verbatim, and it rides the same rounds as the regions,
                # stopping the moment the region evidence settles the plan.
                best = None
                rounds_specs = specs + region_specs
            else:
                # static+verify composition: confident-persist regions take
                # their gain from the reference headroom, so the reference
                # *is* consumed by the decision and must be measured in full.
                best = runner.run(specs)["best"]
                rounds_specs = region_specs

            def _fixed_gain(k: int) -> float:
                # regions static+verify trusts without measuring: same gain
                # attribution as the non-adaptive static+verify path below
                if decisions.get(k) == "persist":
                    return best.recomputability - c_base
                return 0.0

            def _evidence(partial, executed, planned_tests, key, z):
                camp = partial[key]
                vals = [1.0 if rec.outcome == "S1" else 0.0 for rec in camp.records]
                ws = [rec.weight for rec in camp.records]
                done = {t.index for t in executed[key]}
                rem = [
                    t.weight for t in planned_tests[key] if t.index not in done
                ]
                return final_rate_interval(vals, ws, rem, z)

            def _should_stop(partial, executed, planned_tests) -> bool:
                point_gains: Dict[int, float] = {}
                boxes: Dict[int, Tuple[float, float]] = {}
                for k in range(n_regions):
                    if k in campaigned:
                        lo, hi, rate, _ = _evidence(
                            partial, executed, planned_tests,
                            f"region:{k}", stopping.z,
                        )
                        if rate != rate:  # no evidence yet
                            return False
                        point_gains[k] = rate - c_base
                        boxes[k] = (lo - c_base, hi - c_base)
                    else:
                        point_gains[k] = _fixed_gain(k)
                return selection_invariant(
                    point_gains, boxes, overheads, c_base, t_s=t_s, tau=tau,
                    freq_options=freq_options, max_corners=stopping.max_corners,
                ) is not None

            if rounds_specs:
                rounds = runner.run_rounds(
                    rounds_specs, stopping.round_tests, stopping.min_rounds,
                    _should_stop,
                )
            else:
                rounds = RoundsResult({}, {}, {}, 0, 0, False)
            if best_in_rounds:
                best = rounds.campaigns["best"]
                campaigns = dict(rounds.campaigns)
            else:
                campaigns = {"best": best, **rounds.campaigns}
            evidence = []
            for k in region_ids:
                lo, hi, rate, n_eff = _evidence(
                    rounds.campaigns, rounds.executed, rounds.planned,
                    f"region:{k}", stopping.z,
                )
                evidence.append(RegionEvidence(
                    region=k,
                    executed=rounds.campaigns[f"region:{k}"].n,
                    planned=per_region_n,
                    rate=rate,
                    interval=(lo, hi),
                    n_eff=n_eff,
                ))
            reference_ev = None
            if best_in_rounds:
                lo, hi, rate, n_eff = _evidence(
                    rounds.campaigns, rounds.executed, rounds.planned,
                    "best", stopping.z,
                )
                reference_ev = RegionEvidence(
                    region=-1,
                    executed=best.n,
                    planned=n_tests,
                    rate=rate,
                    interval=(lo, hi),
                    n_eff=n_eff,
                )
            adaptive_report = AdaptiveReport(
                rounds_executed=rounds.rounds_executed,
                rounds_total=rounds.rounds_total,
                stopped_early=rounds.stopped_early,
                tests_executed=sum(c.n for c in rounds.campaigns.values()),
                tests_planned=(
                    per_region_n * len(region_ids)
                    + (n_tests if best_in_rounds else 0)
                ),
                regions=tuple(evidence),
                stopping=stopping.spec(),
                sampler=None if sampler is None else sampler.spec(),
                reference=reference_ev,
            )
        else:
            specs += region_specs
            campaigns = runner.run(specs)
            best = campaigns["best"]

        if region_measure == "paper":
            c_base_map = baseline.per_region_recomputability()
            c_max_map = best.per_region_recomputability()
            c_base = [c_base_map.get(k, (baseline.recomputability, 0))[0] for k in range(n_regions)]
            c_max = [
                max(c_max_map.get(k, (best.recomputability, 0))[0], c_base[k])
                for k in range(n_regions)
            ]
            sel = select_regions(a, c_base, c_max, l, t_s=t_s, tau=tau, freq_options=freq_options)
        else:
            decisions = (
                {r.index: r.decision for r in static_plan.regions}
                if static_plan is not None else {}
            )
            gains = {}
            overheads = {}
            for k in range(n_regions):
                camp_k = campaigns.get(f"region:{k}")
                if camp_k is not None:
                    # the self-normalized weighted rate: recovers the
                    # uniform-draw estimate under importance sampling and is
                    # numerically identical to .recomputability without it
                    gains[k] = camp_k.weighted_recomputability - baseline.recomputability
                elif decisions.get(k) == "persist":
                    # confident static persist: the best campaign's headroom
                    # is the gain flushing every iteration at one region can
                    # at most realize — the same quantity the measured
                    # isolated campaign estimates
                    gains[k] = best.recomputability - baseline.recomputability
                else:
                    gains[k] = 0.0  # confident static skip: no gain, DP drops it
                overheads[k] = l[k]
            sel = select_regions_from_gains(
                gains, overheads, baseline.recomputability, t_s=t_s, tau=tau,
                freq_options=freq_options,
            )
    finally:
        runner.close()

    executed = baseline.n + best.n + sum(
        c.n for key, c in campaigns.items() if key.startswith("region:")
    )
    plan = PersistPlan(objects=crit, region_freq=sel.plan_freqs())
    return WorkflowResult(
        app_name=app.name,
        baseline_campaign=baseline,
        object_scores=scores,
        critical=crit,
        best_campaign=best,
        region_selection=sel,
        plan=plan,
        tau=tau,
        t_s=t_s,
        plan_source=cfg.plan_source,
        tests_executed=int(executed),
        static_plan=static_plan,
        adaptive=adaptive_report,
    )
