"""The port's SOR app against the JAX package's, on the CPU.

The sweep and the Laplacian are bitwise equal to JAX's (the port writes the
sweep's last op as ``torch.addcmul``, which rounds once as XLA's fused
multiply-add does), so these tests demand exact equality; the campaign and
workflow tests hold the port to the pinned goldens and the JAX plan.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.workflow import WorkflowConfig as JaxWorkflowConfig
from repro.core.workflow import run_workflow as jax_run_workflow
from repro.hpc import sor as jsor
from repro.hpc.common import laplacian_apply as jax_laplacian
from repro.hpc.common import rel_residual as jax_rel_residual
from repro.hpc.suite import ci_app as jax_ci_app
from repro.hpc.suite import default_cache as jax_default_cache
from repro_torch.core import CrashTester, PersistPlan, get_fault_model
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc import sor as tsor
from repro_torch.hpc.common import laplacian_apply, rel_residual
from repro_torch.hpc.suite import ci_app, default_cache

GOLDENS = os.path.join(os.path.dirname(__file__), "golden", "campaign_goldens.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _inputs(g, lanes=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (g * g,) if lanes is None else (lanes, g * g)
    u = rng.standard_normal(shape).astype(np.float32)
    b = jsor.SORApp(grid=g).init(0)["b"]
    return u, (b if lanes is None else np.stack([b] * lanes))


@pytest.mark.parametrize("g", [24, 33])
def test_laplacian_bitwise(g):
    u, _ = _inputs(g)
    want = jax_laplacian(jnp.asarray(u), g)
    assert _bits(laplacian_apply(torch.from_numpy(u), g)) == _bits(want)


@pytest.mark.parametrize("pairs", [1, 2, 50])
@pytest.mark.parametrize("g", [24, 33])
def test_rb_sor_bitwise(g, pairs):
    u, b = _inputs(g)
    omega = jsor.SORApp(grid=g).omega
    want = jsor._rb_sor(jnp.asarray(u), jnp.asarray(b), g, omega, pairs)
    got = tsor._rb_sor(torch.from_numpy(u), torch.from_numpy(b), g, omega, pairs)
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("g", [24, 33])
def test_batched_kernels_bitwise(g):
    u, b = _inputs(g, lanes=5, seed=1)
    omega = jsor.SORApp(grid=g).omega
    assert _bits(laplacian_apply(torch.from_numpy(u), g)) == _bits(
        jsor._lap_batch(jnp.asarray(u), g))
    assert _bits(tsor._rb_sor(torch.from_numpy(u), torch.from_numpy(b), g, omega, 2)) == _bits(
        jsor._rb_sor_batch(jnp.asarray(u), jnp.asarray(b), g, omega, 2))


def _lane_states(app, n=4):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        s = app.init(0)
        s["u"] = (rng.standard_normal(s["u"].shape) * 0.1 * i).astype(np.float32)
        s["k"] = np.array([i], np.int64)
        out.append(s)
    return out


def test_batched_hooks_bitwise_equal_jax_and_serial():
    """run_iteration_batch equals JAX's and the port's serial iteration per
    lane, bit for bit; the batched convergence and verification agree."""
    japp, tapp = jax_ci_app("sor"), ci_app("sor", device="cpu")
    states = _lane_states(tapp)
    jb = japp.run_iteration_batch(states)
    tb = tapp.run_iteration_batch(states)
    for s, j, t in zip(states, jb, tb):
        serial = tapp.run_iteration(s)
        for k in ("u", "res", "k", "b"):
            assert _bits(t[k]) == _bits(j[k]) == _bits(serial[k]), k
    its = [0, 5, 119, 120]
    assert tapp.converged_batch(tb, its) == japp.converged_batch(jb, its)
    assert tapp.converged_batch(tb, its) == [tapp.converged(s, i) for s, i in zip(tb, its)]
    assert [v.spec() for v in tapp.verify_batch(tb)] == [v.spec() for v in japp.verify_batch(jb)]


def test_regions_keep_numpy_and_tensor_state():
    app = ci_app("sor", device="cpu")
    s = app.init(0)
    s["u"] = _inputs(24)[0]
    out = app.run_iteration(s)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    st = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    out_t = app.run_iteration(st)
    assert all(isinstance(v, torch.Tensor) for v in out_t.values())
    for k in out:
        assert out_t[k].numpy().tobytes() == out[k].tobytes()
    want = jax_rel_residual(out["u"], out["b"], 24)
    assert rel_residual(out["u"], out["b"], 24, "cpu") == want
    assert rel_residual(out_t["u"], out_t["b"], 24, "cpu") == want


def test_golden_run_bitwise_equal_jax():
    jstate, jn = jax_ci_app("sor").run_golden(0)
    tstate, tn = ci_app("sor", device="cpu").run_golden(0)
    assert tn == jn == 33
    for k in jstate:
        assert _bits(tstate[k]) == _bits(jstate[k]), k


def _campaign_entry(app, engine=None, fault_name=None):
    fault = get_fault_model(fault_name, app=app) if fault_name else None
    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=123,
                       fault=fault, engine=engine).run_campaign(8)
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


@pytest.mark.parametrize("engine", ["ref", "vec"])
def test_campaign_reproduces_sor_golden(engine):
    with open(GOLDENS) as f:
        goldens = json.load(f)
    assert goldens["config"] == {"n_tests": 8, "seed": 123, "plan": "none"}
    got = _campaign_entry(ci_app("sor", device="cpu"), engine=engine)
    assert got == goldens["apps"]["sor"]


def test_torn_write_campaign_reproduces_sor_golden():
    with open(GOLDENS) as f:
        want = json.load(f)["torn_write_apps"]["sor"]
    assert _campaign_entry(ci_app("sor", device="cpu"), fault_name="torn-write") == want


def test_workflow_plan_equals_jax_plan():
    japp = jax_ci_app("sor")
    jplan = jax_run_workflow(
        japp, JaxWorkflowConfig(n_tests=24, cache=jax_default_cache(japp), seed=0)).plan
    app = ci_app("sor", device="cpu")
    wf = run_workflow(app, WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0))
    assert wf.plan.objects == jplan.objects == ("u",)
    assert wf.plan.region_freq == jplan.region_freq == {1: 4, 2: 1}


def test_non_measured_plan_source_not_ported():
    app = ci_app("sor", device="cpu")
    with pytest.raises(NotImplementedError, match="module item 9"):
        run_workflow(app, WorkflowConfig(n_tests=4, cache=default_cache(app), seed=0,
                                         plan_source="static"))
