"""The port's fleet simulator (a copy of repro/core/fleetsim.py) and
``serve.fleet_report`` against the JAX package's: the pinned fleet goldens
exactly, simulate_fleet / fleet_frontier documents equal to JAX's, the
property tests (derandomized: the same examples every run), and reference
fault 3 pinned as the JAX package has it."""
import argparse
import json
import math
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import fleetsim as jax_fleetsim
from repro.core import sysim as jax_sysim
from repro.core.efficiency import SystemConfig as JaxSystemConfig
from repro.launch import serve as jax_serve
from repro_torch.core import (
    POLICIES,
    ArrivalProcess,
    FleetConfig,
    FleetResult,
    PoissonTrace,
    RecomputeProfile,
    ServiceModel,
    SystemConfig,
    fleet_frontier,
    simulate_fleet,
)
from repro_torch.launch import serve

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "fleet_goldens.json")
_INT_KEYS = ("arrived", "served", "dropped", "dropped_down", "in_flight", "slo_violations",
             "n_failures", "n_checkpoints", "n_nvm_recoveries", "n_fallbacks",
             "n_cold_restarts")
_FLOAT_KEYS = ("goodput", "slo_violation_frac", "availability", "latency_p50",
               "latency_p95", "latency_p99", "latency_mean", "latency_max")
FRACTIONS = {"S1": 0.75, "S2": 0.15, "S3": 0.05, "S4": 0.05}
HIST = ((2, 4), (9, 1))


def _profiles():
    return (RecomputeProfile.from_fractions("decode", FRACTIONS, extra_iters_hist=HIST),
            jax_sysim.RecomputeProfile.from_fractions("decode", FRACTIONS,
                                                      extra_iters_hist=HIST))


def _configs(seed, trace="poisson", **over):
    """The same fleet in both packages."""
    def one(fs, ss, sysc):
        tr = (ss.PoissonTrace(mtbf=600.0) if trace == "poisson"
              else ss.WeibullTrace(mtbf=600.0, shape=0.7))
        base = dict(n_replicas=3, arrival=fs.ArrivalProcess(rate=3.0, amplitude=0.25),
                    service=fs.ServiceModel(mean_s=0.4, sigma=0.5, prefill_s=0.8),
                    trace=tr, system=sysc(mtbf=1800.0, t_chk=20.0, nvm_restore_time=2.0),
                    slo_latency=1.5, queue_cap=32, horizon=900.0, t_s=0.02, seed=seed)
        base.update(over)
        return fs.FleetConfig(**base)

    from repro_torch.core import fleetsim as port_fleetsim
    from repro_torch.core import sysim as port_sysim
    return (one(port_fleetsim, port_sysim, SystemConfig),
            one(jax_fleetsim, jax_sysim, JaxSystemConfig))


def _golden_config() -> FleetConfig:
    return FleetConfig(
        n_replicas=3,
        arrival=ArrivalProcess(rate=2.5, amplitude=0.3),
        service=ServiceModel(mean_s=0.4, sigma=0.5, prefill_s=0.8),
        trace=PoissonTrace(mtbf=400.0),
        system=SystemConfig(mtbf=400.0, t_chk=15.0, nvm_restore_time=2.0),
        slo_latency=1.5, queue_cap=24, horizon=1200.0, t_s=0.02, seed=321,
    )


@pytest.mark.parametrize("policy", POLICIES)
def test_port_reproduces_fleet_goldens(policy):
    with open(GOLDEN_PATH) as f:
        goldens = json.load(f)
    cfg = _golden_config()
    assert goldens["fingerprint"] == cfg.fingerprint()
    prof = RecomputeProfile.from_fractions(
        "golden", {"S1": 0.7, "S2": 0.2, "S3": 0.05, "S4": 0.05},
        extra_iters_hist=((2, 3), (8, 1)))
    p = simulate_fleet(policy, cfg, prof if policy in ("easycrash", "hybrid") else None).payload()
    got = {k: p[k] for k in _INT_KEYS}
    got.update({k: round(p[k], 6) for k in _FLOAT_KEYS})
    assert got == goldens["policies"][policy]


@pytest.mark.parametrize("trace", ["poisson", "weibull"])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_simulate_fleet_and_frontier_equal_jax(seed, trace):
    cfg, jcfg = _configs(seed, trace)
    prof, jprof = _profiles()
    assert cfg.spec() == jcfg.spec() and cfg.fingerprint() == jcfg.fingerprint()
    for policy in POLICIES:
        use = policy in ("easycrash", "hybrid")
        got = simulate_fleet(policy, cfg, prof if use else None).payload()
        want = jax_fleetsim.simulate_fleet(policy, jcfg, jprof if use else None).payload()
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), policy
    got = fleet_frontier(cfg, prof)
    want = jax_fleetsim.fleet_frontier(jcfg, jprof)
    assert json.dumps(got, sort_keys=True, allow_nan=False) == json.dumps(want, sort_keys=True)


def test_result_is_frozen_and_config_validates():
    cfg, _ = _configs(0)
    r = simulate_fleet("none", cfg.replace(horizon=300.0))
    assert isinstance(r, FleetResult)
    with pytest.raises(Exception):
        r.goodput = 1.0
    for bad in (dict(n_replicas=0), dict(horizon=0.0), dict(queue_cap=0),
                dict(slo_latency=0.0), dict(t_s=1.0), dict(t_iter=-1.0), dict(interval=0.0)):
        with pytest.raises(ValueError):
            cfg.replace(**bad)


def test_fault_3_pinned_as_in_jax():
    """Reference fault 3, copied on purpose: a subnormal rate puts the next
    arrival at infinity and rate_at's sin(inf) raises, in both packages."""
    errors = []
    for arrival in (ArrivalProcess(rate=5e-324), jax_fleetsim.ArrivalProcess(rate=5e-324)):
        with pytest.raises(ValueError) as info:
            arrival.next_arrival(np.random.default_rng(0), 0.0)
        errors.append(str(info.value))
    assert errors[0] == errors[1] == "math domain error"
    assert math.isinf(1.0 / 5e-324)


# ---------------------------------------------- properties (derandomized)
@settings(max_examples=25, deadline=None, derandomize=True)
@given(
    policy=st.sampled_from(POLICIES),
    seed=st.integers(0, 2**31 - 1),
    rate=st.floats(0.0, 5.0),
    amplitude=st.floats(0.0, 0.9),
    mtbf=st.floats(120.0, 1e6),
    sigma=st.floats(0.0, 1.2),
    n_replicas=st.integers(1, 5),
    queue_cap=st.integers(1, 40),
    t_s=st.floats(0.0, 0.3),
)
def test_request_conservation_and_time_partition(
    policy, seed, rate, amplitude, mtbf, sigma, n_replicas, queue_cap, t_s
):
    cfg = FleetConfig(
        n_replicas=n_replicas,
        arrival=ArrivalProcess(rate=rate, amplitude=amplitude),
        service=ServiceModel(mean_s=0.4, sigma=sigma, prefill_s=0.8),
        trace=PoissonTrace(mtbf=mtbf),
        system=SystemConfig(mtbf=1800.0, t_chk=20.0, nvm_restore_time=2.0),
        slo_latency=1.5, queue_cap=queue_cap, horizon=900.0, t_s=t_s, seed=seed,
    )
    prof, _ = _profiles()
    r = simulate_fleet(policy, cfg, prof if policy in ("easycrash", "hybrid") else None)
    assert r.arrived == r.served + r.dropped + r.in_flight
    assert r.dropped_down <= r.dropped
    assert sum(r.breakdown.values()) == pytest.approx(cfg.n_replicas * cfg.horizon, abs=1e-6)
    assert 0.0 <= r.availability <= 1.0
    assert 0.0 <= r.slo_violation_frac <= 1.0
    if r.served:
        assert r.latency_p50 <= r.latency_p95 <= r.latency_p99 <= r.latency_max


@settings(max_examples=15, deadline=None, derandomize=True)
@given(policy=st.sampled_from(POLICIES), seed=st.integers(0, 2**31 - 1))
def test_identical_seeds_are_byte_identical(policy, seed):
    cfg, _ = _configs(seed, horizon=600.0)
    prof, _ = _profiles()
    use = prof if policy in ("easycrash", "hybrid") else None
    a, b = simulate_fleet(policy, cfg, use), simulate_fleet(policy, cfg, use)
    assert a == b
    assert json.dumps(a.payload(), sort_keys=True) == json.dumps(b.payload(), sort_keys=True)


# ------------------------------------------------------------ fleet_report
@pytest.mark.parametrize("stats,extra", [
    ({"decode_steps": 64, "tokens_per_s": 61.2, "bytes_written": 48_000_000}, []),
    ({"decode_steps": 32, "tokens_per_s": 250.0, "bytes_written": 9_000_000},
     ["--fleet-rate", "1.5", "--fleet-replicas", "6", "--seed", "3"]),
])
def test_fleet_report_equals_jax(stats, extra, capsys):
    args = serve.parser().parse_args(["--fleet", "--fleet-horizon", "900", *extra])
    got = serve.fleet_report(dict(stats), args)
    out = capsys.readouterr().out
    want = jax_serve.fleet_report(dict(stats), argparse.Namespace(**vars(args)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert capsys.readouterr().out == out  # the same lines, in the same order
    for policy in POLICIES:
        assert f"[fleet] {policy:10s} goodput=" in out
