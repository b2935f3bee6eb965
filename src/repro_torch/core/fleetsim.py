# Port copy of repro/core/fleetsim.py.  What differs: FleetConfig.fingerprint
# hashes its spec here (_payload_fingerprint, the same SHA-256 of the same
# canonical JSON as artifacts.payload_fingerprint), since core/artifacts.py
# is not copied yet (ROADMAP, module item 9).  Everything else is unchanged,
# reference fault 3 included: ArrivalProcess.rate_at raises on sin(inf)
# when a subnormal rate puts the next arrival at infinity (ROADMAP §3).
"""Fleet-scale serving-under-failure simulator (the ROADMAP's "millions of
users" story, built on the §7 single-job machinery in :mod:`repro.core.sysim`).

:func:`~repro.core.sysim.simulate_policy` scores one HPC job's *efficiency*
under a failure trace.  A serving deployment is a different animal: N
replicas answer an open-loop request stream, and a crash does not cost
abstract "useful time" — it costs *requests*: queues back up behind the dead
replica, tail latency explodes, and a cold restart forces every interrupted
session to re-run prefill because the KV cache died with the process.
EasyCrash's claim translates directly: an NVM-recovered replica warm-starts
with its KV/recurrent caches intact (sessions resume mid-decode), while a
checkpoint restore or bare restart comes back cold.

This module plays that tape.  :func:`simulate_fleet` is a seeded
discrete-event simulation of a replica fleet:

* **arrivals** — open-loop nonhomogeneous Poisson (:class:`ArrivalProcess`),
  diurnally modulated (Lewis thinning, so the stream is seeded and exact);
* **service** — heavy-tail lognormal per-request work
  (:class:`ServiceModel`); requests join the shortest backlog among live
  replicas, bounded queues drop on overflow, arrivals with no live replica
  are lost;
* **failures** — each replica fails independently per a
  :class:`~repro.core.sysim.FailureTrace` (Poisson/Weibull/
  :func:`~repro.core.sysim.scaled_trace`, shared with ``sysim``);
* **recovery** — per the protection policy under test (same four names as
  ``sysim``): ``none`` restarts cold; ``checkpoint`` restores from the last
  checkpoint (cold); ``easycrash`` draws the outcome from a campaign-measured
  :class:`~repro.core.sysim.RecomputeProfile` — S1/S2 warm-start from the
  NVM image (S2 pays recompute iterations drawn from the measured
  extra-iteration histogram), S3/S4 restart cold; ``hybrid`` falls back to
  the checkpoint instead of restarting.  Failures that strike *during*
  recovery restart the recovery with a fresh outcome draw, exactly like
  ``sysim``;
* **persistence cost** — the checkpointing policies pause serving for
  ``t_chk`` at the (Young/stretched-Young) interval between requests, and
  the EasyCrash policies inflate every service time by ``1 / (1 - t_s)``
  where ``t_s`` is the measured delta-flush overhead
  (:func:`~repro.core.efficiency.persist_overhead_fraction` of
  ``ManagerStats.bytes_written``) — persist traffic is charged against
  serving capacity, per Huang et al.'s persistence-cost analysis.

**Warm vs cold** is the mechanism under study: a warm recovery resumes the
preempted request with its remaining work and keeps the queue intact; a cold
recovery keeps the queue (sessions retry) but marks every queued request
``needs_prefill`` — each pays :attr:`ServiceModel.prefill_s` again before
decoding resumes, and the interrupted request starts its service over.

The simulator reports goodput, request loss, SLO-violation fraction, and
p50/p95/p99 latency (:class:`FleetResult`), plus an availability/breakdown
accounting that reduces to ``sysim``'s single-job buckets when the fleet is
one replica with no traffic (the differential oracle in
``tests/test_fleetsim.py``).

Everything is seeded and single-threaded: the same
``(policy, FleetConfig, profile)`` reproduces the same :class:`FleetResult`
bit for bit.  Arrival, service, per-replica failure, and recovery-outcome
draws come from *independent* spawned streams, so changing the failure trace
never perturbs the offered load — policy comparisons run against the same
request tape.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .efficiency import SystemConfig
from .sysim import (
    POLICIES,
    SECONDS_PER_DAY,
    FailureTrace,
    PoissonTrace,
    RecomputeProfile,
    default_interval,
)

FLEET_VERSION = 1


def _payload_fingerprint(payload: Dict[str, object]) -> str:
    """SHA-256 of the canonical strict JSON of ``payload``."""
    return hashlib.sha256(json.dumps(payload, sort_keys=True, separators=(",", ":"),
                                     allow_nan=False).encode()).hexdigest()

#: event kinds, in deterministic tie-break order (heap entries carry a
#: monotone sequence number, so same-time events process in push order)
_ARRIVAL, _DEPART, _FAIL, _RECOVER, _CKPT_START, _CKPT_END = range(6)


# ------------------------------------------------------------- load models
@dataclass(frozen=True)
class ArrivalProcess:
    """Open-loop nonhomogeneous Poisson arrivals with diurnal modulation.

    The instantaneous rate is ``rate * (1 + amplitude * sin(2*pi*t/period +
    phase))`` requests/second fleet-wide; draws use Lewis thinning against
    the peak rate so the stream is exact and consumes a deterministic,
    trace-independent RNG stream.  ``rate=0`` produces no arrivals (the
    no-traffic reduction used by the ``sysim`` differential test).
    """

    rate: float
    amplitude: float = 0.0
    period: float = SECONDS_PER_DAY
    phase: float = 0.0

    def __post_init__(self):
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got {self.amplitude}")
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")

    def rate_at(self, t: float) -> float:
        return self.rate * (1.0 + self.amplitude
                            * math.sin(2.0 * math.pi * t / self.period + self.phase))

    def next_arrival(self, rng: np.random.Generator, t: float) -> float:
        """The first arrival after ``t`` (Lewis thinning); inf if rate=0."""
        peak = self.rate * (1.0 + self.amplitude)
        if peak <= 0.0:
            return math.inf
        while True:
            t += float(rng.exponential(1.0 / peak))
            if float(rng.random()) * peak <= self.rate_at(t):
                return t

    def spec(self) -> Dict[str, object]:
        return {"rate": float(self.rate), "amplitude": float(self.amplitude),
                "period": float(self.period), "phase": float(self.phase)}


@dataclass(frozen=True)
class ServiceModel:
    """Heavy-tail (lognormal) per-request service times.

    ``mean_s`` is the *mean* service time (``mu`` is derived so the lognormal
    mean lands there); ``sigma`` is the lognormal shape — 0 degenerates to
    deterministic service.  ``prefill_s`` is the extra work a request pays
    when its session's KV cache is gone (cold recovery re-prefill); the
    steady-state cost of its own prefill is already inside ``mean_s``.
    """

    mean_s: float = 0.5
    sigma: float = 0.6
    prefill_s: float = 1.0

    def __post_init__(self):
        if self.mean_s <= 0:
            raise ValueError(f"mean_s must be positive, got {self.mean_s}")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")
        if self.prefill_s < 0:
            raise ValueError(f"prefill_s must be >= 0, got {self.prefill_s}")

    def draw(self, rng: np.random.Generator) -> float:
        mu = math.log(self.mean_s) - 0.5 * self.sigma * self.sigma
        return float(rng.lognormal(mu, self.sigma))

    def spec(self) -> Dict[str, object]:
        return {"mean_s": float(self.mean_s), "sigma": float(self.sigma),
                "prefill_s": float(self.prefill_s)}


# ------------------------------------------------------------ fleet config
@dataclass(frozen=True)
class FleetConfig:
    """Everything :func:`simulate_fleet` needs besides the policy and the
    profile, in one frozen, validated object (mirroring
    :class:`~repro.core.workflow.WorkflowConfig`): :meth:`spec` is the single
    serialization point and :meth:`fingerprint` the artifact identity.

    ``t_s`` is the EasyCrash flush-overhead fraction charged against the
    serving rate of the ``easycrash``/``hybrid`` policies (measure it with
    :func:`~repro.core.efficiency.persist_overhead_fraction` from delta-mode
    ``bytes_written``); ``t_iter`` converts the profile's S2
    extra-recompute-iteration draws into downtime seconds (a serving
    "iteration" is one decode step, so it is orders of magnitude below the
    HPC default).  ``interval`` overrides the Young/stretched-Young
    checkpoint interval; ``None`` uses
    :func:`~repro.core.sysim.default_interval` at the replica trace's MTBF.
    """

    n_replicas: int = 4
    arrival: ArrivalProcess = ArrivalProcess(rate=4.0, amplitude=0.3)
    service: ServiceModel = ServiceModel()
    trace: FailureTrace = PoissonTrace(mtbf=2 * 3600.0)
    system: SystemConfig = SystemConfig(mtbf=2 * 3600.0, t_chk=20.0,
                                        nvm_restore_time=2.0)
    slo_latency: float = 2.0
    queue_cap: int = 64
    horizon: float = 4 * 3600.0
    interval: Optional[float] = None
    t_s: float = 0.0
    t_iter: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.horizon <= 0:
            raise ValueError(f"horizon must be positive, got {self.horizon}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.slo_latency <= 0:
            raise ValueError(f"slo_latency must be positive, got {self.slo_latency}")
        if not 0.0 <= self.t_s < 1.0:
            raise ValueError(f"t_s must be in [0, 1), got {self.t_s}")
        if self.t_iter < 0:
            raise ValueError(f"t_iter must be >= 0, got {self.t_iter}")
        if self.interval is not None and self.interval <= 0:
            raise ValueError(f"interval must be positive, got {self.interval}")

    def replace(self, **overrides) -> "FleetConfig":
        """A copy with the given fields overridden (re-validated)."""
        return dataclasses.replace(self, **overrides)

    def spec(self) -> Dict[str, object]:
        """Fleet identity (JSON-round-trip safe) for artifacts and goldens."""
        return {
            "fleet_version": FLEET_VERSION,
            "n_replicas": int(self.n_replicas),
            "arrival": self.arrival.spec(),
            "service": self.service.spec(),
            "trace": self.trace.spec(),
            "system": {
                "mtbf": float(self.system.mtbf),
                "t_chk": float(self.system.t_chk),
                "t_sync": float(self.system.t_sync),
                "t_r": float(self.system.t_r),
                "nvm_restore_time": float(self.system.nvm_restore_time),
            },
            "slo_latency": float(self.slo_latency),
            "queue_cap": int(self.queue_cap),
            "horizon": float(self.horizon),
            "interval": None if self.interval is None else float(self.interval),
            "t_s": float(self.t_s),
            "t_iter": float(self.t_iter),
            "seed": int(self.seed),
        }

    def fingerprint(self) -> str:
        return _payload_fingerprint(self.spec())


# ------------------------------------------------------------ fleet result
@dataclass(frozen=True)
class FleetResult:
    """One policy's serving record over the horizon.

    ``arrived == served + dropped + in_flight`` holds exactly (request
    conservation); ``breakdown`` buckets replica-seconds by state (``up`` /
    ``checkpoint`` / ``down``) and sums to ``n_replicas * horizon``.
    Latency percentiles are 0 when nothing was served (strict-JSON safe).
    """

    policy: str
    goodput: float               # served requests / second of horizon
    offered_rate: float          # arrived requests / second of horizon
    arrived: int
    served: int
    dropped: int                 # queue overflow + no-live-replica losses
    dropped_down: int            # the no-live-replica share of ``dropped``
    in_flight: int               # queued or in service when the tape ends
    slo_violations: int          # served with latency > slo_latency
    slo_violation_frac: float    # ... as a fraction of served (0 if none)
    latency_p50: float
    latency_p95: float
    latency_p99: float
    latency_mean: float
    latency_max: float
    availability: float          # up replica-seconds / total replica-seconds
    interval: float              # checkpoint interval used (0 if none)
    n_failures: int
    n_checkpoints: int
    n_nvm_recoveries: int        # warm recoveries from the NVM image (S1/S2)
    n_fallbacks: int             # recoveries via checkpoint restore
    n_cold_restarts: int         # recoveries with nothing to restore
    breakdown: Dict[str, float]  # replica-seconds per state bucket

    def payload(self) -> Dict[str, object]:
        """Strict-JSON dict (the frontier/golden/bench serialization)."""
        d = dataclasses.asdict(self)
        d["breakdown"] = {k: float(v) for k, v in sorted(d["breakdown"].items())}
        return d

    def spec(self) -> Dict[str, object]:
        return self.payload()


# --------------------------------------------------------------- internals
class _Request:
    __slots__ = ("arr", "work", "needs_prefill", "work_left")

    def __init__(self, arr: float, work: float):
        self.arr = arr
        self.work = work
        self.needs_prefill = False   # cold recovery: pay prefill_s again
        self.work_left: Optional[float] = None  # warm preemption: resume here


class _Replica:
    __slots__ = ("idx", "up", "queue", "current", "epoch", "ckpt_active",
                 "next_ckpt_due", "service_end", "state_label", "state_since")

    def __init__(self, idx: int):
        self.idx = idx
        self.up = True
        self.queue: deque = deque()
        self.current: Optional[_Request] = None
        self.epoch = 0               # bumped on failure: stale events ignored
        self.ckpt_active = False
        self.next_ckpt_due = math.inf
        self.service_end = 0.0       # when the in-service request departs
        self.state_label = "up"
        self.state_since = 0.0

    def backlog(self) -> int:
        return len(self.queue) + (1 if self.current is not None else 0)


@dataclass
class _Tally:
    arrived: int = 0
    served: int = 0
    dropped_queue: int = 0
    dropped_down: int = 0
    n_failures: int = 0
    n_checkpoints: int = 0
    n_nvm: int = 0
    n_fallbacks: int = 0
    n_cold: int = 0
    latencies: List[float] = field(default_factory=list)
    buckets: Dict[str, float] = field(default_factory=dict)


def _percentile(lat: np.ndarray, q: float) -> float:
    return float(np.percentile(lat, q)) if lat.size else 0.0


# ------------------------------------------------------------ the simulator
def simulate_fleet(
    policy: str,
    config: FleetConfig,
    profile: Optional[RecomputeProfile] = None,
) -> FleetResult:
    """Play the request tape against a failing fleet under one policy.

    ``profile`` (required for ``easycrash``/``hybrid``) supplies the
    campaign-measured S1–S4 outcome draw and the S2 extra-iteration
    histogram; build it from the ``decode`` app's campaign
    (:meth:`RecomputeProfile.from_campaign`) for the serving story the
    ROADMAP asks for.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (one of {POLICIES})")
    if policy in ("easycrash", "hybrid") and profile is None:
        raise ValueError(f"policy {policy!r} needs a RecomputeProfile")

    system, trace, horizon = config.system, config.trace, config.horizon
    checkpointing = policy in ("checkpoint", "hybrid")
    interval = 0.0
    if checkpointing:
        interval = (config.interval if config.interval is not None
                    else default_interval(policy, system, trace, profile))
    inflate = 1.0 / (1.0 - config.t_s) if policy in ("easycrash", "hybrid") else 1.0

    # independent streams: the offered load never shifts with the trace
    ss = np.random.SeedSequence(config.seed)
    children = ss.spawn(3 + config.n_replicas)
    rng_arrival = np.random.default_rng(children[0])
    rng_service = np.random.default_rng(children[1])
    rng_outcome = np.random.default_rng(children[2])
    rng_fail = [np.random.default_rng(c) for c in children[3:]]

    replicas = [_Replica(i) for i in range(config.n_replicas)]
    tally = _Tally()
    heap: List[Tuple[float, int, int, int, int]] = []  # (t, seq, kind, replica, epoch)
    seq = 0

    def push(t: float, kind: int, ridx: int, epoch: int) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, ridx, epoch))
        seq += 1

    def set_state(r: _Replica, label: str, now: float) -> None:
        tally.buckets[r.state_label] = (
            tally.buckets.get(r.state_label, 0.0) + now - r.state_since
        )
        r.state_label, r.state_since = label, now

    def start_service(r: _Replica, now: float) -> None:
        req = r.queue.popleft()
        r.current = req
        if req.work_left is not None:        # warm-resumed preemption
            remaining = req.work_left
            req.work_left = None
        else:
            extra = config.service.prefill_s if req.needs_prefill else 0.0
            req.needs_prefill = False
            remaining = (req.work + extra) * inflate
        r.service_end = now + remaining
        push(r.service_end, _DEPART, r.idx, r.epoch)

    def begin_checkpoint(r: _Replica, now: float) -> None:
        r.ckpt_active = True
        set_state(r, "checkpoint", now)
        push(now + system.t_chk, _CKPT_END, r.idx, r.epoch)

    def next_step(r: _Replica, now: float) -> None:
        """Replica is up with no request in service: checkpoint if due,
        serve if backlogged, else idle (with a wake-up at the due time)."""
        if checkpointing and now >= r.next_ckpt_due and not r.ckpt_active:
            begin_checkpoint(r, now)
        elif r.queue:
            start_service(r, now)
        elif checkpointing and math.isfinite(r.next_ckpt_due):
            push(r.next_ckpt_due, _CKPT_START, r.idx, r.epoch)

    def begin_recovery(r: _Replica, now: float) -> None:
        """Draw this attempt's recovery path; a failure mid-recovery lands
        back here with a fresh draw (same semantics as ``sysim``)."""
        if policy == "checkpoint":
            tally.n_fallbacks += 1
            duration, warm = system.t_r + system.t_sync, False
        elif policy == "none":
            tally.n_cold += 1
            duration, warm = system.t_sync, False
        else:
            outcome = profile.draw_outcome(rng_outcome)
            if outcome in ("S1", "S2"):
                tally.n_nvm += 1
                duration, warm = system.nvm_restore_time + system.t_sync, True
                if outcome == "S2":
                    duration += profile.draw_extra_iters(rng_outcome) * config.t_iter
            elif policy == "hybrid":
                tally.n_fallbacks += 1
                duration, warm = system.t_r + system.t_sync, False
            else:
                tally.n_cold += 1
                duration, warm = system.t_sync, False
        if not warm:
            # the KV caches died with the process: every queued session must
            # re-prefill, and the interrupted request starts its service over
            for req in r.queue:
                req.needs_prefill = True
                req.work_left = None
        push(now + duration, _RECOVER, r.idx, r.epoch)

    # initial events
    first = config.arrival.next_arrival(rng_arrival, 0.0)
    if math.isfinite(first):
        push(first, _ARRIVAL, -1, 0)
    for r in replicas:
        push(trace.interarrival(rng_fail[r.idx]), _FAIL, r.idx, 0)
        if checkpointing:
            r.next_ckpt_due = interval
            push(r.next_ckpt_due, _CKPT_START, r.idx, r.epoch)

    now = 0.0
    while heap:
        t, _, kind, ridx, epoch = heapq.heappop(heap)
        if t >= horizon:
            break
        now = t
        if kind == _ARRIVAL:
            tally.arrived += 1
            work = config.service.draw(rng_service)  # stream-stable draw
            live = [r for r in replicas if r.up]
            if not live:
                tally.dropped_down += 1
            else:
                r = min(live, key=lambda x: (x.backlog(), x.idx))
                if r.backlog() >= config.queue_cap:
                    tally.dropped_queue += 1
                else:
                    r.queue.append(_Request(now, work))
                    if r.current is None and not r.ckpt_active:
                        next_step(r, now)
            nxt = config.arrival.next_arrival(rng_arrival, now)
            if math.isfinite(nxt):
                push(nxt, _ARRIVAL, -1, 0)
            continue

        r = replicas[ridx]
        if kind == _FAIL:
            tally.n_failures += 1
            push(now + trace.interarrival(rng_fail[ridx]), _FAIL, ridx, 0)
            r.epoch += 1          # invalidate depart/ckpt/recover in flight
            if r.up:
                r.up = False
                r.ckpt_active = False
                set_state(r, "down", now)
                if r.current is not None:
                    # preempt: park at the queue head with its remaining work
                    # (resumed as-is on a warm recovery; a cold recovery
                    # resets it to a full redo below, in begin_recovery)
                    req = r.current
                    r.current = None
                    req.work_left = max(0.0, r.service_end - now)
                    r.queue.appendleft(req)
            begin_recovery(r, now)
            continue
        if epoch != r.epoch:
            continue  # stale event from before this replica's last failure

        if kind == _DEPART:
            req = r.current
            r.current = None
            tally.served += 1
            lat = now - req.arr
            tally.latencies.append(lat)
            next_step(r, now)
        elif kind == _RECOVER:
            r.up = True
            set_state(r, "up", now)
            if checkpointing:
                r.next_ckpt_due = now + interval
            next_step(r, now)
        elif kind == _CKPT_START:
            if r.up and r.current is None and not r.ckpt_active \
                    and now >= r.next_ckpt_due:
                begin_checkpoint(r, now)
        elif kind == _CKPT_END:
            r.ckpt_active = False
            tally.n_checkpoints += 1
            r.next_ckpt_due = now + interval
            set_state(r, "up", now)
            next_step(r, now)

    # close the books at the horizon
    for r in replicas:
        set_state(r, r.state_label, horizon)
    in_flight = sum(r.backlog() for r in replicas)
    dropped = tally.dropped_queue + tally.dropped_down
    lat = np.asarray(sorted(tally.latencies), dtype=np.float64)
    n_slo = int(np.count_nonzero(lat > config.slo_latency))
    total_rs = config.n_replicas * horizon
    return FleetResult(
        policy=policy,
        goodput=tally.served / horizon,
        offered_rate=tally.arrived / horizon,
        arrived=tally.arrived,
        served=tally.served,
        dropped=dropped,
        dropped_down=tally.dropped_down,
        in_flight=in_flight,
        slo_violations=n_slo,
        slo_violation_frac=n_slo / tally.served if tally.served else 0.0,
        latency_p50=_percentile(lat, 50),
        latency_p95=_percentile(lat, 95),
        latency_p99=_percentile(lat, 99),
        latency_mean=float(lat.mean()) if lat.size else 0.0,
        latency_max=float(lat.max()) if lat.size else 0.0,
        availability=tally.buckets.get("up", 0.0) / total_rs,
        interval=interval,
        n_failures=tally.n_failures,
        n_checkpoints=tally.n_checkpoints,
        n_nvm_recoveries=tally.n_nvm,
        n_fallbacks=tally.n_fallbacks,
        n_cold_restarts=tally.n_cold,
        breakdown=dict(tally.buckets),
    )


# ---------------------------------------------------------- policy frontier
def fleet_frontier(
    config: FleetConfig,
    profile: RecomputeProfile,
    *,
    policies: Sequence[str] = POLICIES,
) -> Dict[str, object]:
    """All policies against the same request tape, as one JSON-serializable
    policy-frontier document (the fleet analogue of
    :func:`~repro.core.sysim.efficiency_frontier`)."""
    doc: Dict[str, object] = {
        "config": config.spec(),
        "fingerprint": config.fingerprint(),
        "profile": {
            "app": profile.app_name,
            "fault": dict(profile.fault_spec),
            "fractions": {c: float(profile.fractions.get(c, 0.0))
                          for c in ("S1", "S2", "S3", "S4")},
            "success_rate": profile.success_rate,
            "mean_extra_iters": profile.mean_extra_iters(),
            "n_records": profile.n_records,
        },
        "policies": {},
    }
    for policy in policies:
        prof = profile if policy in ("easycrash", "hybrid") else None
        doc["policies"][policy] = simulate_fleet(policy, config, prof).payload()
    return doc


__all__ = [
    "FLEET_VERSION",
    "ArrivalProcess",
    "ServiceModel",
    "FleetConfig",
    "FleetResult",
    "simulate_fleet",
    "fleet_frontier",
]
