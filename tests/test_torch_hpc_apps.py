"""The port's heat, cg, pagerank, kmeans, mg and montecarlo apps against the
JAX package's apps and pins, on the CPU.

Per app: the golden run's length equals JAX's; the CI campaign reproduces
the app's pin in ``tests/golden/campaign_goldens.json`` under both engines,
and its RecomputeProfile the pinned profile; kmeans and pagerank reproduce
their torn-write pins, and so does mg; ``run_workflow`` gives the JAX plan (pinned below:
the JAX package's run_workflow on ``ci_app(name)`` with
``WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)``, jax 0.9.0
on the CPU).  Within the port: a batched lane is bitwise the serial lane,
and a tensor state steps to the same bytes as a numpy state.  The step
functions against JAX's are in
``tests/test_torch_{heat,cg,pagerank,kmeans,mg,montecarlo}.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.hpc.suite import ci_app as jax_ci_app
from repro_torch.core import CrashTester, PersistPlan, RecomputeProfile, get_fault_model
from repro_torch.core.artifacts import profile_to_payload
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import NOT_PORTED, ci_app, default_cache, get_app

GOLDENS = os.path.join(os.path.dirname(__file__), "golden", "campaign_goldens.json")
APPS = ("heat", "cg", "pagerank", "kmeans", "mg", "montecarlo")
#: the JAX package's plans (objects, region frequencies)
JAX_PLANS = {
    "heat": (("u",), {}),
    "cg": (("q",), {2: 1, 3: 1}),
    "pagerank": (("rank",), {0: 1, 1: 1, 2: 1}),
    "kmeans": (("centroids",), {0: 1, 1: 1}),
    "mg": (("u",), {1: 1, 3: 1}),
    "montecarlo": (("counts", "sums"), {0: 1, 1: 1}),
}
#: the float object each lane test perturbs
PERTURB = {"heat": "u", "cg": "x", "pagerank": "rank", "kmeans": "centroids", "mg": "u",
           "montecarlo": "sums"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _campaign(app, engine=None, fault_name=None):
    fault = get_fault_model(fault_name, app=app) if fault_name else None
    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=123,
                       fault=fault, engine=engine).run_campaign(8)
    return camp, fault


def _entry(camp):
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


def _lane_states(app, name, iters=(0, 3, 7, 19)):
    """Lanes from the app's own trajectory (k differs per lane; cg's lane at
    k 19 takes a residual replacement), each with one float object
    perturbed."""
    rng = np.random.default_rng(4)
    out = []
    for n in iters:
        s = app.init(0)
        for _ in range(n):
            s = app.run_iteration(s)
        v = s[PERTURB[name]]
        s[PERTURB[name]] = (v * (1 + 1e-3 * rng.standard_normal(v.shape))).astype(v.dtype)
        out.append(s)
    return out


@pytest.mark.parametrize("name", APPS)
def test_golden_run_length_equals_jax(name):
    jstate, jn = jax_ci_app(name).run_golden(0)
    tstate, tn = ci_app(name, device="cpu").run_golden(0)
    assert tn == jn == _goldens()["apps"][name]["golden_iters"]
    assert set(tstate) == set(jstate)
    for k in jstate:
        assert tstate[k].dtype == jstate[k].dtype and tstate[k].shape == jstate[k].shape, k


@pytest.mark.parametrize("engine", ["ref", "vec"])
@pytest.mark.parametrize("name", APPS)
def test_campaign_reproduces_golden(name, engine):
    goldens = _goldens()
    assert goldens["config"] == {"n_tests": 8, "seed": 123, "plan": "none"}
    camp, _ = _campaign(ci_app(name, device="cpu"), engine=engine)
    assert _entry(camp) == goldens["apps"][name]


@pytest.mark.parametrize("name", APPS)
def test_recompute_profile_reproduces_golden(name):
    camp, fault = _campaign(ci_app(name, device="cpu"))
    got = profile_to_payload(RecomputeProfile.from_campaign(camp, fault=fault))
    assert got == _goldens()["profiles"][name]


@pytest.mark.parametrize("name", ["kmeans", "pagerank", "mg"])
def test_torn_write_campaign_reproduces_golden(name):
    camp, _ = _campaign(ci_app(name, device="cpu"), fault_name="torn-write")
    assert _entry(camp) == _goldens()["torn_write_apps"][name]


@pytest.mark.parametrize("name", APPS)
def test_workflow_plan_equals_jax_plan(name):
    app = ci_app(name, device="cpu")
    plan = run_workflow(app, WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)).plan
    assert (plan.objects, dict(plan.region_freq)) == JAX_PLANS[name]


@pytest.mark.parametrize("name", APPS)
def test_batched_lanes_bitwise_equal_serial(name):
    app = ci_app(name, device="cpu")
    states = _lane_states(app, name)
    batched = app.run_iteration_batch(states)
    for s, b in zip(states, batched):
        serial = app.run_iteration(s)
        assert set(b) == set(serial)
        for k in serial:
            assert b[k].dtype == serial[k].dtype and _bits(b[k]) == _bits(serial[k]), k
    its = [0, 5, app.n_iters - 1, app.n_iters]
    assert app.converged_batch(batched, its) == [app.converged(s, i)
                                                 for s, i in zip(batched, its)]
    assert [v.spec() for v in app.verify_batch(batched)] == [
        app.verify(s).spec() for s in batched]


@pytest.mark.parametrize("name", APPS)
def test_tensor_state_steps_like_numpy_state(name):
    """The deployment keeps the state in tensors; a tensor state steps to
    the same bytes as the numpy state the crash tester uses."""
    app = ci_app(name, device="cpu")
    s = _lane_states(app, name, iters=(2,))[0]
    out = app.run_iteration(s)
    out_t = app.run_iteration({k: torch.from_numpy(np.array(v)) for k, v in s.items()})
    assert set(out_t) == set(out)
    for k in out:
        assert isinstance(out_t[k], torch.Tensor) and isinstance(out[k], np.ndarray), k
        assert out_t[k].dtype == torch.from_numpy(out[k]).dtype, k
        assert _bits(out_t[k]) == _bits(out[k]), k
    assert app.progress(out_t) == app.progress(out)


@pytest.mark.parametrize("name,item", [("montecarlo", "4.5"), ("mg", "4.6")])
def test_unported_apps_name_their_items(name, item):
    """The apps of module items 4.5 and 4.6 are ported: registered, and no
    longer named in NOT_PORTED."""
    assert name not in NOT_PORTED, f"module item {item}"
    app = get_app(name, device="cpu")
    assert app.name == name and app.supports_lane_driver
