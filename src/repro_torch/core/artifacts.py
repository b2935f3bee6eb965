# Port copy of repro/core/artifacts.py.  What differs: this header, and
# StaticPlanArtifact.static_plan imports the port's analysis.classify (its
# relative import resolves inside repro_torch).  The envelopes, payloads and
# fingerprints are the JAX package's byte for byte, so each package loads
# the other's artifacts.
"""Portable, fingerprinted workflow artifacts (paper §5.3 step 4).

The product EasyCrash ships is not a campaign log — it is the *persist plan*:
which data objects to flush, at which code regions, how often.  This module
makes that product a portable file:

* :func:`save_plan` / :func:`load_plan` — a :class:`PersistPlan` plus the
  context it was characterized in (app, fault model, tau, expected
  recomputability), serialized to JSON with a content fingerprint;
* :func:`save_workflow` / :func:`load_workflow` — the full
  :class:`~repro.core.workflow.WorkflowResult` summary (object scores,
  region choices, campaign outcome fractions) in the same envelope;
* :func:`replay_plan` — re-run a crash campaign under a loaded plan, by
  default under the fault model the plan was characterized with, or under
  any other (the cross-fault robustness question: does a plan characterized
  under clean power failures survive deployment under torn writes?).

Envelope: ``{"kind": ..., "version": ..., "fingerprint": sha256(payload),
"payload": {...}}``.  The fingerprint is over the canonical (sorted-key,
no-whitespace) JSON payload; loading verifies it and raises
:class:`ArtifactError` on any mismatch — a truncated download or a hand-
edited plan must never silently steer a production run.
"""
from __future__ import annotations

import hashlib
import io
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

from .cache_sim import CacheConfig
from .crash_tester import CampaignResult, CrashTester, PersistPlan
from .durable import durable_replace
from .faults import FaultModel, fault_model_from_spec
from .regions import IterativeApp

from .sysim import RecomputeProfile

ARTIFACT_VERSION = 1
PLAN_KIND = "easycrash-persist-plan"
WORKFLOW_KIND = "easycrash-workflow-result"
PROFILE_KIND = "easycrash-recompute-profile"
STATIC_PLAN_KIND = "easycrash-static-plan"


class ArtifactError(RuntimeError):
    """Raised for corrupt, tampered, or mismatched artifact files."""


# ------------------------------------------------------------------ envelope
def _canonical(payload: Mapping[str, object]) -> str:
    # allow_nan=False: artifacts are *portable* — a NaN token parses in
    # Python but is rejected by strict JSON consumers (jq, JSON.parse).
    # Non-finite values must be mapped to null by the codecs before here.
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _finite_or_none(x: float) -> Optional[float]:
    """Strict-JSON stand-in for possibly-non-finite statistics (Spearman rs
    of a constant vector is NaN by contract; ``tau_threshold`` returns inf
    when EasyCrash can never win)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _nan_if_none(x: Optional[object]) -> float:
    """Loader inverse of :func:`_finite_or_none` (null -> nan)."""
    return float("nan") if x is None else float(x)


def _sanitize_meta(meta: Mapping[str, object]) -> Dict[str, object]:
    """Map non-finite float values in caller-supplied metadata to null so
    the strict-JSON encoder never rejects a finished workflow's artifact."""
    return {
        k: _finite_or_none(v) if isinstance(v, float) else v
        for k, v in meta.items()
    }


def payload_fingerprint(payload: Mapping[str, object]) -> str:
    return hashlib.sha256(_canonical(payload).encode()).hexdigest()


def _write_envelope(path: str, kind: str, payload: Mapping[str, object]) -> str:
    """Atomically write an artifact file; returns its fingerprint."""
    fp = payload_fingerprint(payload)
    doc = {
        "kind": kind,
        "version": ARTIFACT_VERSION,
        "fingerprint": fp,
        "payload": payload,
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with io.open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    durable_replace(tmp, path)
    return fp


def _read_envelope(path: str, kind: str) -> Tuple[Dict[str, object], str]:
    try:
        with io.open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    # ValueError covers JSONDecodeError and UnicodeDecodeError (binary
    # garbage over the file) alike — all corruption surfaces as ArtifactError
    except (OSError, ValueError) as e:
        raise ArtifactError(f"{path}: unreadable artifact ({e})") from None
    if not isinstance(doc, dict) or doc.get("kind") != kind:
        raise ArtifactError(
            f"{path}: not a {kind!r} artifact (kind={doc.get('kind')!r})"
        )
    version = doc.get("version")
    if not isinstance(version, int) or version != ARTIFACT_VERSION:
        raise ArtifactError(
            f"{path}: artifact version {version!r} unsupported "
            f"(want {ARTIFACT_VERSION})"
        )
    payload = doc.get("payload")
    if not isinstance(payload, dict):
        raise ArtifactError(f"{path}: artifact has no payload object")
    want = doc.get("fingerprint")
    got = payload_fingerprint(payload)
    if want != got:
        raise ArtifactError(
            f"{path}: fingerprint mismatch — the payload was modified after "
            f"the artifact was written (stored {want!r}, computed {got!r})"
        )
    return payload, got


# ---------------------------------------------------------------- plan codec
def cache_to_payload(cache: Optional[CacheConfig]) -> Optional[Dict[str, int]]:
    if cache is None:
        return None
    return {
        "capacity_blocks": int(cache.capacity_blocks),
        "block_bytes": int(cache.block_bytes),
    }


def cache_from_payload(d: Optional[Mapping[str, object]]) -> Optional[CacheConfig]:
    if d is None:
        return None
    return CacheConfig(
        capacity_blocks=int(d["capacity_blocks"]),
        block_bytes=int(d["block_bytes"]),
    )


def plan_to_payload(plan: PersistPlan) -> Dict[str, object]:
    return {
        "objects": list(plan.objects),
        "region_freq": sorted([int(k), int(v)] for k, v in plan.region_freq.items()),
    }


def plan_from_payload(d: Mapping[str, object]) -> PersistPlan:
    return PersistPlan(
        objects=tuple(str(o) for o in d["objects"]),
        region_freq={int(k): int(v) for k, v in d["region_freq"]},
    )


@dataclass(frozen=True)
class PlanArtifact:
    """A loaded persist-plan artifact (verified fingerprint)."""

    app_name: str
    plan: PersistPlan
    fault_spec: Dict[str, object]
    cache: Optional[CacheConfig]
    meta: Dict[str, object]
    fingerprint: str

    @property
    def fault(self) -> FaultModel:
        """The fault model the plan was characterized under."""
        return fault_model_from_spec(self.fault_spec)


def save_plan(
    path: str,
    plan: PersistPlan,
    app_name: str,
    fault: Optional[FaultModel] = None,
    cache: Optional[CacheConfig] = None,
    meta: Optional[Mapping[str, object]] = None,
) -> str:
    """Write a persist-plan artifact; returns its fingerprint.

    ``cache`` records the cache geometry the plan was characterized under —
    replaying under a different geometry yields S1–S4 numbers that are not
    comparable to the characterization, so :func:`replay_plan` defaults to
    the recorded one.
    """
    from .faults import PowerFail

    payload: Dict[str, object] = {
        "app": str(app_name),
        "plan": plan_to_payload(plan),
        "fault": (fault if fault is not None else PowerFail()).spec(),
        "cache": cache_to_payload(cache),
        "meta": _sanitize_meta(meta or {}),
    }
    return _write_envelope(path, PLAN_KIND, payload)


def load_plan(path: str) -> PlanArtifact:
    payload, fp = _read_envelope(path, PLAN_KIND)
    return PlanArtifact(
        app_name=str(payload["app"]),
        plan=plan_from_payload(payload["plan"]),
        fault_spec=dict(payload["fault"]),
        cache=cache_from_payload(payload.get("cache")),
        meta=dict(payload.get("meta", {})),
        fingerprint=fp,
    )


# ------------------------------------------------------------ workflow codec
@dataclass(frozen=True)
class WorkflowArtifact:
    """A loaded workflow-result summary artifact (verified fingerprint)."""

    app_name: str
    plan: PersistPlan
    critical: Tuple[str, ...]
    object_scores: List[Dict[str, object]]
    region_choices: List[Dict[str, object]]
    campaign_fractions: Dict[str, Dict[str, float]]
    summary: Dict[str, float]
    tau: float
    t_s: float
    fault_spec: Dict[str, object]
    cache: Optional[CacheConfig]
    fingerprint: str
    plan_source: str = "measured"
    #: the sequential scheduler's stopping decision + per-region evidence
    #: (an :meth:`repro.core.adaptive.AdaptiveReport.to_payload` document),
    #: present only for adaptively-run workflows
    adaptive: Optional[Dict[str, object]] = None

    @property
    def fault(self) -> FaultModel:
        return fault_model_from_spec(self.fault_spec)

    def adaptive_report(self):
        """Rehydrated :class:`~repro.core.adaptive.AdaptiveReport` (or None)."""
        if self.adaptive is None:
            return None
        from .adaptive import AdaptiveReport

        return AdaptiveReport.from_payload(self.adaptive)


def save_workflow(
    path: str,
    wf,  # WorkflowResult (not imported to avoid a cycle)
    fault: Optional[FaultModel] = None,
    cache: Optional[CacheConfig] = None,
) -> str:
    """Write a workflow-result summary artifact; returns its fingerprint.

    Carries everything step 4 (production) and the paper's figures need —
    the plan, the Spearman scores, the knapsack choices, per-campaign
    S1–S4 fractions — but not the raw crash records (those live in the
    :class:`~repro.core.campaign_store.WorkflowStore`, if one was attached).
    """
    from .faults import PowerFail

    payload: Dict[str, object] = {
        "app": str(wf.app_name),
        "plan": plan_to_payload(wf.plan),
        "critical": list(wf.critical),
        "object_scores": [
            {"name": s.name, "rs": _finite_or_none(s.rs),
             "p_value": _finite_or_none(s.p_value),
             "critical": bool(s.critical)}
            for s in wf.object_scores
        ],
        "region_choices": [
            {"region_idx": int(c.region_idx), "freq": int(c.freq),
             "gain": _finite_or_none(c.gain),
             "overhead": _finite_or_none(c.overhead)}
            for c in wf.region_selection.choices
        ],
        "campaign_fractions": (
            {
                "baseline": wf.baseline_campaign.class_fractions(),
                "best": wf.best_campaign.class_fractions(),
            }
            # a static-plan workflow measured no campaigns at all
            if wf.baseline_campaign is not None and wf.best_campaign is not None
            else {}
        ),
        "summary": {k: _finite_or_none(v) for k, v in wf.summary().items()},
        "tau": _finite_or_none(wf.tau),
        "t_s": _finite_or_none(wf.t_s),
        "fault": (fault if fault is not None else PowerFail()).spec(),
        "cache": cache_to_payload(cache),
    }
    # only when non-default, so historical artifact fingerprints are unchanged
    plan_source = getattr(wf, "plan_source", "measured")
    if plan_source != "measured":
        payload["plan_source"] = str(plan_source)
    adaptive = getattr(wf, "adaptive", None)
    if adaptive is not None:
        # stopping decision, weights/evidence, sampler spec — the envelope
        # records *why* the adaptive plan is trustworthy, not just the plan
        payload["adaptive"] = adaptive.to_payload()
    return _write_envelope(path, WORKFLOW_KIND, payload)


def load_workflow(path: str) -> WorkflowArtifact:
    payload, fp = _read_envelope(path, WORKFLOW_KIND)
    return WorkflowArtifact(
        app_name=str(payload["app"]),
        plan=plan_from_payload(payload["plan"]),
        critical=tuple(str(o) for o in payload["critical"]),
        object_scores=list(payload["object_scores"]),
        region_choices=list(payload["region_choices"]),
        campaign_fractions={
            k: {c: float(x) for c, x in v.items()}
            for k, v in dict(payload["campaign_fractions"]).items()
        },
        summary={k: _nan_if_none(v) for k, v in dict(payload["summary"]).items()},
        tau=_nan_if_none(payload["tau"]),
        t_s=_nan_if_none(payload["t_s"]),
        fault_spec=dict(payload["fault"]),
        cache=cache_from_payload(payload.get("cache")),
        fingerprint=fp,
        plan_source=str(payload.get("plan_source", "measured")),
        adaptive=(
            dict(payload["adaptive"]) if payload.get("adaptive") is not None
            else None
        ),
    )


# ---------------------------------------------------------- static-plan codec
@dataclass(frozen=True)
class StaticPlanArtifact:
    """A loaded static persist-plan prediction (verified fingerprint).

    The payload is the :meth:`repro.analysis.classify.StaticPlan.to_payload`
    document: per-object classification + confidence, per-region decision +
    estimated write traffic.  :meth:`static_plan` rehydrates the dataclass
    (imported lazily — core does not depend on the analysis package).
    """

    app_name: str
    payload: Dict[str, object]
    meta: Dict[str, object]
    fingerprint: str

    def static_plan(self):
        from ..analysis.classify import StaticPlan

        return StaticPlan.from_payload(self.payload)


def save_static_plan(path: str, static_plan,
                     meta: Optional[Mapping[str, object]] = None) -> str:
    """Write a static persist-plan artifact; returns its fingerprint.

    ``static_plan`` is duck-typed (anything with ``to_payload()``), so the
    analysis package stays an optional consumer of core, not a dependency.
    """
    payload: Dict[str, object] = dict(static_plan.to_payload())
    payload["meta"] = _sanitize_meta(meta or {})
    return _write_envelope(path, STATIC_PLAN_KIND, payload)


def load_static_plan(path: str) -> StaticPlanArtifact:
    payload, fp = _read_envelope(path, STATIC_PLAN_KIND)
    return StaticPlanArtifact(
        app_name=str(payload["app"]),
        payload={k: v for k, v in payload.items() if k != "meta"},
        meta=dict(payload.get("meta", {})),
        fingerprint=fp,
    )


# ------------------------------------------------------------- profile codec
def profile_to_payload(profile: RecomputeProfile) -> Dict[str, object]:
    return {
        "app": str(profile.app_name),
        "fault": dict(profile.fault_spec),
        "fractions": {
            c: float(profile.fractions.get(c, 0.0))
            for c in ("S1", "S2", "S3", "S4")
        },
        "extra_iters_hist": [[int(i), int(c)] for i, c in profile.extra_iters_hist],
        "golden_iters": int(profile.golden_iters),
        "n_records": int(profile.n_records),
    }


def profile_from_payload(d: Mapping[str, object]) -> RecomputeProfile:
    return RecomputeProfile(
        app_name=str(d["app"]),
        fault_spec=dict(d["fault"]),
        fractions={k: float(v) for k, v in dict(d["fractions"]).items()},
        extra_iters_hist=tuple((int(i), int(c)) for i, c in d["extra_iters_hist"]),
        golden_iters=int(d["golden_iters"]),
        n_records=int(d["n_records"]),
    )


@dataclass(frozen=True)
class ProfileArtifact:
    """A loaded recompute-profile artifact (verified fingerprint)."""

    profile: RecomputeProfile
    meta: Dict[str, object]
    fingerprint: str

    @property
    def app_name(self) -> str:
        return self.profile.app_name

    @property
    def fault(self) -> FaultModel:
        """The fault model the profile's campaign ran under."""
        return fault_model_from_spec(self.profile.fault_spec)


def save_profile(
    path: str,
    profile: RecomputeProfile,
    meta: Optional[Mapping[str, object]] = None,
) -> str:
    """Write a recompute-profile artifact; returns its fingerprint.

    This is the contract between the characterization pipeline and the
    system simulator: per-app, per-fault-model S1–S4 rates plus the measured
    extra-recompute-iteration histogram, fingerprinted so a hand-edited or
    truncated profile can never silently steer an efficiency study.
    """
    payload: Dict[str, object] = profile_to_payload(profile)
    payload["meta"] = _sanitize_meta(meta or {})
    return _write_envelope(path, PROFILE_KIND, payload)


def load_profile(path: str) -> ProfileArtifact:
    payload, fp = _read_envelope(path, PROFILE_KIND)
    return ProfileArtifact(
        profile=profile_from_payload(payload),
        meta=dict(payload.get("meta", {})),
        fingerprint=fp,
    )


def profile_from_workflow(
    artifact: "WorkflowArtifact", which: str = "best"
) -> RecomputeProfile:
    """A :class:`RecomputeProfile` from a stored workflow summary.

    Workflow artifacts carry per-campaign S1–S4 fractions but not the raw
    records, so the recompute-cost histogram is empty — the simulator then
    prices S2 recoveries at the NVM-restore cost alone (optimistic; prefer a
    profile saved by :func:`save_profile` from a live campaign when one is
    available).  ``which`` selects the measured campaign: ``"best"``
    (persist-everywhere, the plan's upper bound) or ``"baseline"``.
    """
    if which not in artifact.campaign_fractions:
        raise ArtifactError(
            f"workflow artifact has no {which!r} campaign "
            f"(have {sorted(artifact.campaign_fractions)})"
        )
    return RecomputeProfile.from_fractions(
        artifact.app_name,
        artifact.campaign_fractions[which],
        fault_spec=artifact.fault_spec,
    )


# -------------------------------------------------------------------- replay
def replay_plan(
    artifact: Union[str, PlanArtifact, WorkflowArtifact],
    app: IterativeApp,
    cache: Optional[CacheConfig] = None,
    n_tests: int = 100,
    seed: int = 0,
    fault: Optional[FaultModel] = None,
    n_workers: int = 1,
    store_path: Optional[str] = None,
) -> CampaignResult:
    """Run a crash campaign under a plan loaded from an artifact.

    ``fault=None`` replays under the model the plan was characterized with,
    and ``cache=None`` under the recorded characterization cache geometry
    (both rehydrated from the artifact) — replaying under a different model
    is the cross-fault robustness experiment of
    ``benchmarks/bench_recomputability.py --robustness-matrix``; S1–S4
    numbers from a *different cache geometry* would not be comparable to
    the artifact's recorded expectations, so only pass ``cache`` when that
    shift is the experiment.
    """
    if isinstance(artifact, (str, os.PathLike)):
        artifact = load_plan(os.fspath(artifact))
    if artifact.app_name != app.name:
        raise ArtifactError(
            f"plan artifact belongs to app {artifact.app_name!r}, "
            f"cannot replay on {app.name!r}"
        )
    if fault is None:
        fault = artifact.fault
    if cache is None:
        cache = artifact.cache if artifact.cache is not None else CacheConfig()
    tester = CrashTester(app, artifact.plan, cache, seed=seed, fault=fault)
    return tester.run_campaign(n_tests, n_workers=n_workers, store_path=store_path)
