"""The port's static analyzer and its three plan sources against the JAX
package's, on the CPU.

The oracle is the live JAX analyzer.  It runs here because a module-scoped
fixture restores the one symbol jax 0.9.0 moved (``jax.core.Literal``, now
``jax.extend.core.Literal``) for this file alone, and undoes it at teardown,
so the JAX package's own analyzer tests fail as they do without it.

* Per app, for all seven suite apps: ``analyze_app`` equals JAX's region by
  region (traced flag, decision, write_bytes, rationale; confidence within
  1e-4) and object by object (class, decision, rationale; confidence and
  damping within 1e-4), with the same uncertain regions.
* The pins of ``tests/test_static_plan.py`` hold unchanged on the port's
  plans (agreement with ``tests/golden/static_agreement.json``, the two
  annotated misses, the classification and uncertainty pins).
* The slice as a whole: ``run_workflow`` on sor with ``static`` (0 tests)
  and ``static+verify`` (80 tests against the measured 170) equals JAX's,
  and ``adaptive`` reproduces ``tests/golden/adaptive_goldens.json`` for
  every app (exact sampler) and for pagerank, kmeans and cg (the default
  importance sampler, whose prior is the static plan's window confidences).
"""
import json
import math
import os

import pytest
import torch

from repro_torch.analysis import CONFIDENCE_THRESHOLD, analyze_app
from repro_torch.analysis.fx_walk import UNTRACED, trace_region
from repro_torch.core import SequentialConfig, load_static_plan, save_static_plan
from repro_torch.core.artifacts import ArtifactError
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import ci_app, default_cache

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "static_agreement.json")
ADAPTIVE_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "adaptive_goldens.json")
SUITE = ("sor", "pagerank", "kmeans", "heat", "mg", "cg", "montecarlo")
N_TESTS = 40

# ---- carried unchanged from tests/test_static_plan.py ----------------------
#: apps whose static region decisions exactly match the measured workflow.
#: mg and cg are the two designed-in misses; everything else must agree —
#: acceptance bar is >= 5 of 7.
EXPECTED_AGREE = {"sor", "pagerank", "kmeans", "heat", "montecarlo"}

#: per-app expected-disagreement annotations for the two misses, asserted
#: exactly (region sets, not just "disagrees") so drift on either side
#: surfaces here.
EXPECTED_DISAGREEMENT = {
    "mg": {
        "static_only": [2],
        "measured_only": [1],
        "verify_repairable": False,
    },
    "cg": {
        "static_only": [1],
        "measured_only": [],
        "verify_repairable": True,
    },
}
# ---------------------------------------------------------------------------

#: the JAX analyzer's result per app (jax 0.9.0 on the CPU, ci_app sizes):
#: region -> (traced, decision, confidence rounded to 4, write_bytes), and
#: object -> (class, decision)
TABLE = {
    "sor": ({"residual": (True, "skip", 0.95, 2304), "sweep": (True, "persist", 0.9, 2304),
             "book": (True, "persist", 0.9, 4)},
            {"u": ("accumulator", "persist"), "res": ("dead", "skip")}),
    "heat": ({"flux": (True, "skip", 0.9, 4096), "update": (True, "skip", 0.3519, 4096),
              "pin": (False, "skip", 0.3519, 4104)},
             {"u": ("accumulator", "skip")}),
    "cg": ({"matvec": (True, "skip", 0.95, 2304), "x_update": (False, "persist", 0.35, 2308),
            "r_update": (False, "persist", 0.35, 2312),
            "p_update": (False, "persist", 0.35, 2312)},
           {"x": ("crash-critical", "persist"), "r": ("crash-critical", "persist"),
            "p": ("crash-critical", "persist"), "q": ("dead", "skip"),
            "rho": ("crash-critical", "persist"), "rho_prev": ("crash-critical", "persist"),
            "alpha": ("crash-critical", "persist")}),
    "montecarlo": ({"generate": (False, "skip", 0.9, 4096),
                    "accumulate": (False, "persist", 0.9, 104)},
                   {"counts": ("crash-critical", "persist"),
                    "sums": ("crash-critical", "persist")}),
    "mg": ({"R1_residual": (True, "skip", 0.95, 4096), "R2_coarse": (True, "skip", 0.9, 1024),
            "R3_correct": (True, "persist", 0.891, 4096),
            "R4_smooth": (True, "persist", 0.891, 4100)},
           {"u": ("accumulator", "persist"), "r": ("dead", "skip")}),
    "pagerank": ({"spmv": (True, "persist", 0.7427, 768),
                  "apply": (True, "persist", 0.7427, 772),
                  "book": (True, "persist", 0.7427, 4)},
                 {"rank": ("accumulator", "persist"), "y": ("dead", "skip")}),
    "kmeans": ({"assign": (True, "persist", 0.85, 2400), "update": (True, "persist", 0.85, 388)},
               {"centroids": ("crash-critical", "persist")}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_analyzer():
    """The JAX package's analyzer, runnable: ``jax.core.Literal`` restored
    for this module only, and removed again at teardown."""
    import jax
    import jax.extend.core

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
        from repro.analysis import analyze_app as jax_analyze_app
        from repro.core.workflow import WorkflowConfig as JaxWorkflowConfig
        from repro.core.workflow import run_workflow as jax_run_workflow
        from repro.hpc.suite import ci_app as jax_ci_app
        from repro.hpc.suite import default_cache as jax_default_cache

        yield {"analyze_app": jax_analyze_app, "ci_app": jax_ci_app,
               "default_cache": jax_default_cache, "run_workflow": jax_run_workflow,
               "WorkflowConfig": JaxWorkflowConfig}


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def adaptive_golden():
    with open(ADAPTIVE_GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def plans():
    out = {}
    for name in SUITE:
        app = ci_app(name, device="cpu")
        out[name] = analyze_app(app, cache=default_cache(app))
    return out


@pytest.fixture(scope="module")
def jax_plans(jax_analyzer):
    out = {}
    for name in SUITE:
        app = jax_analyzer["ci_app"](name)
        out[name] = jax_analyzer["analyze_app"](app, cache=jax_analyzer["default_cache"](app))
    return out


# ------------------------------------------------- per object, against JAX
@pytest.mark.parametrize("name", SUITE)
def test_regions_equal_live_jax_analyzer(name, plans, jax_plans):
    mine, ref = plans[name], jax_plans[name]
    assert [r.name for r in mine.regions] == [r.name for r in ref.regions]
    for r, j in zip(mine.regions, ref.regions):
        assert (r.index, r.traced, r.decision, r.write_bytes, r.rationale) \
            == (j.index, j.traced, j.decision, j.write_bytes, j.rationale), r.name
        assert r.confidence == pytest.approx(j.confidence, abs=1e-4), r.name
    assert mine.uncertain_regions() == ref.uncertain_regions()
    assert mine.write_traffic_bytes() == ref.write_traffic_bytes()
    assert mine.region_overheads == pytest.approx(ref.region_overheads, abs=1e-12)


@pytest.mark.parametrize("name", SUITE)
def test_objects_equal_live_jax_analyzer(name, plans, jax_plans):
    mine, ref = plans[name], jax_plans[name]
    assert [o.name for o in mine.objects] == [o.name for o in ref.objects]
    for o, j in zip(mine.objects, ref.objects):
        assert (o.klass, o.decision, o.rationale) == (j.klass, j.decision, j.rationale), o.name
        assert o.confidence == pytest.approx(j.confidence, abs=1e-4), o.name
        if j.damping is None:
            assert o.damping is None, o.name
        else:
            assert o.damping == pytest.approx(j.damping, abs=1e-4), o.name
    assert mine.persist_objects() == ref.persist_objects()
    assert mine.window_confidences() == pytest.approx(ref.window_confidences(), abs=1e-4)


@pytest.mark.parametrize("name", SUITE)
def test_analyzer_matches_pinned_table(name, plans):
    """The JAX analyzer's result, pinned: holds without the JAX oracle."""
    regions, objects = TABLE[name]
    sp = plans[name]
    assert {r.name: (r.traced, r.decision, round(r.confidence, 4), r.write_bytes)
            for r in sp.regions} == regions
    assert {o.name: (o.klass, o.decision) for o in sp.objects} == objects


def test_heat_pin_region_is_untraced_for_its_in_place_write():
    """heat's pin region writes ``u[pins] = 1.0`` into a copy of state: the
    trace succeeds in torch, and the rule on the graph marks it untraced, as
    jax's immutable arrays refuse it; the update region's pin mask, written
    in place into a fresh tensor, stays traced."""
    app = ci_app("heat", device="cpu")
    state = app.init(0)
    flux, update, pin = (trace_region(state, r, const_objects=frozenset({"pins"}))
                         for r in app.regions())
    assert flux.ok and update.ok and not pin.ok
    assert "index_put_" in pin.error
    assert pin.ops["u"] == frozenset({UNTRACED})
    assert pin.write_bytes == 4096 + 8       # numpy nbytes: u float32, k int64
    assert update.write_bytes == 4096


def test_host_reads_are_untraced():
    """cg's scalar regions read state on the host (float/int): untraced."""
    app = ci_app("cg", device="cpu")
    traces = [trace_region(app.init(0), r, const_objects=frozenset({"b"}))
              for r in app.regions()]
    assert [t.ok for t in traces] == [True, False, False, False]
    assert all("DataDependent" in t.error or "data-dependent" in t.error
               for t in traces[1:])


# ------------------------------ carried unchanged from test_static_plan.py
def test_agreement_with_measured_plans(golden, plans):
    agree = set()
    for name in SUITE:
        static = {r.index for r in plans[name].regions
                  if r.decision == "persist"}
        measured = set(golden[name]["persist_regions"])
        if static == measured:
            agree.add(name)
    assert len(agree) >= 5, f"static agreement below bar: {sorted(agree)}"
    assert agree == EXPECTED_AGREE


def test_expected_disagreement_annotations(golden, plans):
    """The two designed-in misses disagree in exactly the annotated way."""
    for name, note in EXPECTED_DISAGREEMENT.items():
        static = {r.index for r in plans[name].regions
                  if r.decision == "persist"}
        measured = set(golden[name]["persist_regions"])
        assert sorted(static - measured) == note["static_only"], name
        assert sorted(measured - static) == note["measured_only"], name
        flagged = set(plans[name].uncertain_regions())
        disagreeing = (static ^ measured)
        assert note["verify_repairable"] == (disagreeing <= flagged), name
    assert set(EXPECTED_DISAGREEMENT) == set(SUITE) - EXPECTED_AGREE


def test_classification_pins(plans):
    # montecarlo: the exact-accumulator hint wins with high confidence
    for obj in ("counts", "sums"):
        rep = plans["montecarlo"].object_report(obj)
        assert rep.klass == "crash-critical"
        assert rep.confidence == pytest.approx(0.9)
        assert "exact accumulator" in rep.rationale
    # cg: q is overwritten before it is read -> dead across the crash
    q = plans["cg"].object_report("q")
    assert q.klass == "dead"
    assert q.confidence == pytest.approx(0.95)
    # heat: the stencil contracts (damping < threshold) -> self-correcting
    u = plans["heat"].object_report("u")
    assert u.klass == "accumulator"
    assert u.decision == "skip"
    assert u.damping is not None and u.damping < plans["heat"].damping_threshold
    # sor: over-relaxation does not contract -> the accumulator must persist
    s = plans["sor"].object_report("u")
    assert s.klass == "accumulator" and s.decision == "persist"
    assert s.damping is not None and s.damping > plans["sor"].damping_threshold


def test_uncertain_regions_confidence(plans):
    # confident apps prune every region campaign under static+verify
    for name in ("sor", "pagerank", "kmeans", "montecarlo", "mg"):
        assert plans[name].uncertain_regions() == []
    # heat/cg carry low-confidence decisions that verify mode re-measures
    assert plans["heat"].uncertain_regions() == [1, 2]
    assert plans["cg"].uncertain_regions() == [1, 2, 3]
    for name in SUITE:
        for r in plans[name].regions:
            uncertain = r.index in plans[name].uncertain_regions()
            assert uncertain == (r.confidence < CONFIDENCE_THRESHOLD)


def test_write_traffic_positive(plans):
    for name in SUITE:
        assert plans[name].write_traffic_bytes() > 0


# ------------------------------------------------ the slice, against JAX
def _jax_workflow(jax_analyzer, name, **kw):
    app = jax_analyzer["ci_app"](name)
    cfg = jax_analyzer["WorkflowConfig"](n_tests=N_TESTS, seed=0,
                                         cache=jax_analyzer["default_cache"](app), **kw)
    return jax_analyzer["run_workflow"](app, cfg)


def test_pure_static_workflow_runs_no_campaigns(jax_analyzer):
    app = ci_app("sor", device="cpu")
    wf = run_workflow(app, WorkflowConfig(
        n_tests=N_TESTS, seed=0, cache=default_cache(app), plan_source="static"))
    assert wf.plan_source == "static"
    assert wf.tests_executed == 0
    assert wf.baseline_campaign is None and wf.best_campaign is None
    assert wf.critical == ("u",)
    assert dict(wf.plan.region_freq) == {1: 4, 2: 1}
    assert wf.static_plan is not None
    # spec() must stay strict-JSON even with no measured campaigns
    d = json.loads(json.dumps(wf.spec()))
    assert d["plan_source"] == "static"
    assert d["summary"]["baseline_recomputability"] is None
    assert math.isnan(wf.summary()["baseline_recomputability"])
    with pytest.raises(ValueError, match="static"):
        wf.recompute_profile("best")
    ref = _jax_workflow(jax_analyzer, "sor", plan_source="static")
    assert (wf.plan.objects, wf.plan.region_freq, wf.tests_executed) \
        == (ref.plan.objects, ref.plan.region_freq, ref.tests_executed)
    assert json.dumps(wf.spec(), sort_keys=True) == json.dumps(ref.spec(), sort_keys=True)


def test_static_verify_matches_measured_plan_with_fewer_tests(jax_analyzer):
    cache = default_cache(ci_app("sor", device="cpu"))
    measured = run_workflow(ci_app("sor", device="cpu"), WorkflowConfig(
        n_tests=N_TESTS, seed=0, cache=cache))
    verified = run_workflow(ci_app("sor", device="cpu"), WorkflowConfig(
        n_tests=N_TESTS, seed=0, cache=cache, plan_source="static+verify"))
    assert measured.tests_executed == 170
    assert verified.tests_executed == 80   # baseline + best, 0 region campaigns
    assert verified.plan.objects == measured.plan.objects == ("u",)
    assert dict(verified.plan.region_freq) == dict(measured.plan.region_freq)
    saved = 1 - verified.tests_executed / measured.tests_executed
    assert saved >= 0.40
    assert verified.baseline_campaign is not None
    assert verified.best_campaign is not None
    assert verified.plan_source == "static+verify"
    assert measured.plan_source == "measured"
    ref = _jax_workflow(jax_analyzer, "sor", plan_source="static+verify")
    assert (verified.plan.objects, verified.plan.region_freq, verified.tests_executed) \
        == (ref.plan.objects, ref.plan.region_freq, ref.tests_executed)
    assert verified.summary() == ref.summary()


def test_static_plan_artifact_roundtrip(plans, tmp_path):
    sp = plans["pagerank"]
    path = str(tmp_path / "pagerank_static.json")
    fp = save_static_plan(path, sp, meta={"note": "test"})
    art = load_static_plan(path)
    assert art.fingerprint == fp
    assert art.app_name == "pagerank"
    assert art.meta == {"note": "test"}
    rt = art.static_plan()
    assert rt.persist_objects() == sp.persist_objects()
    assert rt.region_decisions() == sp.region_decisions()
    assert rt.uncertain_regions() == sp.uncertain_regions()
    assert [o.klass for o in rt.objects] == [o.klass for o in sp.objects]

    with open(path) as f:
        doc = json.load(f)
    doc["payload"]["app"] = "sor"
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ArtifactError):
        load_static_plan(path)


# ------------------------------------------------------------- adaptive
def _adaptive(name, stopping=None):
    app = ci_app(name, device="cpu")
    return run_workflow(app, WorkflowConfig(
        n_tests=N_TESTS, seed=0, cache=default_cache(app), plan_source="adaptive",
        stopping=stopping))


def _plan_key(wf):
    return {
        "critical": list(wf.plan.objects),
        "region_freq": {str(k): v for k, v in sorted(wf.plan.region_freq.items())},
    }


@pytest.mark.parametrize("name", SUITE)
def test_exact_adaptive_reproduces_goldens(name, adaptive_golden, golden):
    """Uniform-sampler adaptive: the pinned plan (brute force's) and the
    pinned tests-executed count and stop rounds."""
    wf = _adaptive(name, SequentialConfig(sampler_bias=0.0))
    g = adaptive_golden[name]
    rep = wf.adaptive
    assert _plan_key(wf) == g["plan"]
    assert g["plan"]["region_freq"] == golden[name]["region_freq"]
    assert wf.tests_executed == g["exact"]["tests_executed"]
    assert rep.stopped_early == g["exact"]["stopped_early"]
    assert rep.rounds_executed == g["exact"]["rounds_executed"]
    assert rep.rounds_total == g["exact"]["rounds_total"]
    assert wf.tests_executed < golden[name]["n_tests_total"]
    assert rep.tests_skipped == rep.tests_planned - rep.tests_executed
    assert rep.sampler is None
    for ev in rep.regions:
        assert 0 <= ev.executed <= ev.planned
        lo, hi = ev.interval
        assert 0.0 <= lo <= ev.rate <= hi <= 1.0
        assert ev.n_eff == pytest.approx(ev.executed)
    assert rep.reference is not None and rep.reference.region == -1
    assert rep.reference.executed == wf.best_campaign.n


@pytest.mark.parametrize("name", ("pagerank", "kmeans", "cg"))
def test_default_is_adaptive_reproduces_goldens(name, adaptive_golden, golden):
    """Default sampler: the static plan's window confidences are the prior;
    plan agreement and tests executed as pinned (cg is the documented
    knife-edge divergence)."""
    wf = _adaptive(name)
    g = adaptive_golden[name]["default_is"]
    agrees = {str(k): v for k, v in wf.plan.region_freq.items()} == golden[name]["region_freq"]
    assert agrees == g["plan_matches"]
    assert wf.tests_executed == g["tests_executed"]
    assert wf.adaptive.stopped_early == g["stopped_early"]
    assert wf.adaptive.sampler is not None
    assert wf.adaptive.sampler["kind"] == "static-prior"


def test_static_verify_composes_with_stopping():
    """static+verify + stopping on heat: only the uncertain regions [1, 2]
    get sequential campaigns; the persist-everything reference runs in full."""
    app = ci_app("heat", device="cpu")
    wf = run_workflow(app, WorkflowConfig(
        n_tests=N_TESTS, seed=0, cache=default_cache(app), plan_source="static+verify",
        stopping=SequentialConfig()))
    assert dict(wf.plan.region_freq) == {}
    rep = wf.adaptive
    assert rep is not None
    assert rep.reference is None
    assert wf.best_campaign.n == N_TESTS
    assert {ev.region for ev in rep.regions} == {1, 2}
    assert wf.tests_executed < 170
