"""The port's artifacts module (a copy of repro/core/artifacts.py) against
the JAX package's, on the CPU.

* Envelopes the port writes equal JAX's byte for byte for the same plan,
  profile and workflow (sor's measured, static and static+verify
  workflows, and the measured workflow's recompute profile).
* Each package loads the other's envelopes, the static-plan artifact
  included (all seven suite apps, rehydrated by each package's own
  ``StaticPlan``).
* ``FleetConfig.fingerprint`` now goes through the copied
  ``payload_fingerprint``; ``tests/golden/fleet_goldens.json``'s
  fingerprint is unchanged.
* ``replay_plan`` runs a JAX-written plan on the port's app with the same
  S1–S4 outcome as JAX's replay; tampering and foreign apps are refused.

The JAX analyzer runs for the static sources with ``jax.core.Literal``
restored by a module-scoped fixture (see ``tests/test_torch_static_plan.py``).
"""
import json
import os

import pytest
import torch

from repro.core import artifacts as jax_art
from repro.core.crash_tester import PersistPlan as JaxPersistPlan
from repro.core.faults import TornWrite as JaxTornWrite
from repro.hpc.suite import ci_app as jax_ci_app
from repro.hpc.suite import default_cache as jax_default_cache
from repro_torch.core import (
    ArrivalProcess,
    FleetConfig,
    PersistPlan,
    PoissonTrace,
    ServiceModel,
    SystemConfig,
    TornWrite,
)
from repro_torch.core import artifacts as art
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import ci_app, default_cache

FLEET_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fleet_goldens.json")
SUITE = ("sor", "pagerank", "kmeans", "heat", "mg", "cg", "montecarlo")
#: sor's workflows, per plan source: n_tests
SOURCES = {"measured": 24, "static": 40, "static+verify": 40}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_analysis():
    """The JAX package's analyzer and workflow, runnable: ``jax.core.Literal``
    restored for this module only, and removed again at teardown."""
    import jax
    import jax.extend.core

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
        from repro.analysis import analyze_app
        from repro.core import workflow

        yield {"analyze_app": analyze_app, "workflow": workflow}


@pytest.fixture(scope="module")
def workflows(jax_analysis):
    """sor's workflow per plan source, (port, JAX)."""
    jw = jax_analysis["workflow"]
    out = {}
    for source, n in SOURCES.items():
        app = ci_app("sor", device="cpu")
        mine = run_workflow(app, WorkflowConfig(n_tests=n, seed=0, cache=default_cache(app),
                                                plan_source=source))
        japp = jax_ci_app("sor")
        ref = jw.run_workflow(japp, jw.WorkflowConfig(n_tests=n, seed=0,
                                                      cache=jax_default_cache(japp),
                                                      plan_source=source))
        out[source] = (mine, ref)
    return out


def _text(path) -> str:
    with open(path) as f:
        return f.read()


def test_plan_envelope_equals_jax_bytes_and_cross_loads(tmp_path):
    plan = PersistPlan(objects=("u", "r"), region_freq={2: 4, 0: 1})
    jplan = JaxPersistPlan(objects=("u", "r"), region_freq={2: 4, 0: 1})
    cache = default_cache(ci_app("sor", device="cpu"))
    meta = {"tau": 0.25, "note": "x", "nan": float("nan")}
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    fp = art.save_plan(p, plan, "sor", fault=TornWrite(depth=3), cache=cache, meta=meta)
    jfp = jax_art.save_plan(j, jplan, "sor", fault=JaxTornWrite(depth=3),
                            cache=jax_default_cache(jax_ci_app("sor")), meta=meta)
    assert _text(p) == _text(j) and fp == jfp
    mine, theirs = art.load_plan(j), jax_art.load_plan(p)
    assert mine.plan == plan and mine.fault == TornWrite(depth=3)
    assert theirs.plan == jplan and theirs.fault == JaxTornWrite(depth=3)
    assert mine.cache == cache and mine.meta == theirs.meta == {"tau": 0.25, "note": "x",
                                                                 "nan": None}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_workflow_envelope_equals_jax_bytes_and_cross_loads(source, workflows, tmp_path):
    mine, ref = workflows[source]
    assert mine.tests_executed == ref.tests_executed
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    art.save_workflow(p, mine, cache=default_cache(ci_app("sor", device="cpu")))
    jax_art.save_workflow(j, ref, cache=jax_default_cache(jax_ci_app("sor")))
    assert _text(p) == _text(j)
    a, b = art.load_workflow(j), jax_art.load_workflow(p)
    assert a.fingerprint == b.fingerprint
    assert a.plan == mine.plan and tuple(b.plan.objects) == mine.plan.objects
    assert a.plan_source == b.plan_source == source
    assert a.summary.keys() == b.summary.keys()


def test_profile_envelope_equals_jax_bytes_and_cross_loads(workflows, tmp_path):
    mine, ref = workflows["measured"]
    prof, jprof = mine.recompute_profile("best"), ref.recompute_profile("best")
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    art.save_profile(p, prof, meta={"app": "sor"})
    jax_art.save_profile(j, jprof, meta={"app": "sor"})
    assert _text(p) == _text(j)
    assert art.profile_to_payload(prof) == jax_art.profile_to_payload(jprof)
    a, b = art.load_profile(j), jax_art.load_profile(p)
    assert a.profile == prof and b.profile == jprof
    # a profile rebuilt from a JAX workflow artifact
    wpath = str(tmp_path / "wf.json")
    jax_art.save_workflow(wpath, ref)
    from_wf = art.profile_from_workflow(art.load_workflow(wpath), "best")
    assert from_wf.fractions == prof.fractions
    with pytest.raises(art.ArtifactError, match="no 'nope' campaign"):
        art.profile_from_workflow(art.load_workflow(wpath), "nope")


@pytest.mark.parametrize("name", SUITE)
def test_static_plan_artifacts_cross_load(name, jax_analysis, tmp_path):
    from repro_torch.analysis import analyze_app

    app = ci_app(name, device="cpu")
    sp = analyze_app(app, cache=default_cache(app))
    japp = jax_ci_app(name)
    jsp = jax_analysis["analyze_app"](japp, cache=jax_default_cache(japp))
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    fp = art.save_static_plan(p, sp, meta={"app": name})
    jfp = jax_art.save_static_plan(j, jsp, meta={"app": name})
    a, b = art.load_static_plan(j), jax_art.load_static_plan(p)
    assert (a.fingerprint, b.fingerprint) == (jfp, fp)
    assert a.app_name == b.app_name == name and a.meta == b.meta == {"app": name}
    rt, jrt = a.static_plan(), b.static_plan()
    for x, y in ((rt, jsp), (jrt, sp)):
        assert x.persist_objects() == y.persist_objects()
        assert x.region_decisions() == y.region_decisions()
        assert x.uncertain_regions() == y.uncertain_regions()
        assert [o.klass for o in x.objects] == [o.klass for o in y.objects]
    assert type(rt).__module__ == "repro_torch.analysis.classify"


def test_fleet_fingerprint_golden_unchanged():
    with open(FLEET_GOLDEN) as f:
        goldens = json.load(f)
    cfg = FleetConfig(
        n_replicas=3,
        arrival=ArrivalProcess(rate=2.5, amplitude=0.3),
        service=ServiceModel(mean_s=0.4, sigma=0.5, prefill_s=0.8),
        trace=PoissonTrace(mtbf=400.0),
        system=SystemConfig(mtbf=400.0, t_chk=15.0, nvm_restore_time=2.0),
        slo_latency=1.5, queue_cap=24, horizon=1200.0, t_s=0.02, seed=321,
    )
    assert art.payload_fingerprint(cfg.spec()) == cfg.fingerprint() == goldens["fingerprint"]


def test_replay_of_a_jax_plan_matches_jax_replay(tmp_path):
    path = str(tmp_path / "plan.json")
    japp = jax_ci_app("kmeans")
    jax_art.save_plan(path, JaxPersistPlan(objects=("centroids",), region_freq={0: 1, 1: 1}),
                      "kmeans", cache=jax_default_cache(japp))
    ref = jax_art.replay_plan(path, japp, n_tests=8, seed=3)
    mine = art.replay_plan(path, ci_app("kmeans", device="cpu"), n_tests=8, seed=3)
    assert [r.outcome for r in mine.records] == [r.outcome for r in ref.records]
    assert [r.iter_idx for r in mine.records] == [r.iter_idx for r in ref.records]
    assert mine.class_fractions() == ref.class_fractions()


def test_tampered_and_foreign_artifacts_are_refused(tmp_path):
    path = str(tmp_path / "plan.json")
    art.save_plan(path, PersistPlan(objects=("u",), region_freq={1: 2}), "sor")
    with open(path) as f:
        doc = json.load(f)
    with pytest.raises(art.ArtifactError, match="belongs to app 'sor'"):
        art.replay_plan(path, ci_app("kmeans", device="cpu"), n_tests=2)
    doc["payload"]["plan"]["objects"] = ["u", "res"]
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(art.ArtifactError, match="fingerprint mismatch"):
        art.load_plan(path)
    with pytest.raises(art.ArtifactError, match="not a"):
        art.load_workflow(path)
    doc["version"] = 2
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(art.ArtifactError, match="version"):
        art.load_plan(path)
