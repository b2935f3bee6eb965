"""The port's lm-train app, loss_and_aux and _attention_chunked against the
JAX package's, on the CPU.

The app's campaign outcomes hang on its weights (the JAX app gives S1
counts 8, 8, 7, 7 for seeds 0-3), so the pin tests give the port the JAX
app's initial parameter vector and token batches (``use_sources``) and hold
it to the ``apps.lm-train`` pin, its profile and the JAX plan.  With the
port's own generator weights the tests check only what holds for any
weights: the classes partition the records, lanes batch bitwise, the app
pickles.

Tolerances:
* float32 config: the loss within 1e-5 of JAX's, the gradient within 1e-5
  (abs and rel): the two differ only in the order of f32 sums.
* bfloat16 config (the app's default, StableLM's dtype): the loss within
  1e-3 relative and the gradient within 2e-2 in relative L2 norm.  The port
  rounds its bf16 forward as compiled XLA does (its eval loss came out
  equal to JAX's), but autograd's backward rounds its bf16 intermediates
  where XLA's fused backward keeps f32: each bf16 rounding is up to 2^-9
  relative, and a layer's backward chains about ten of them.
* ``_attention_chunked`` in f32: 2e-5 (abs and rel), tests/test_kernels.py's
  attention tolerance.
"""
import dataclasses
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.hpc.suite import get_app as jax_get_app
from repro.models import attention as jattn
from repro.models import train_app as jtrain
from repro_torch.configs import get_arch
from repro_torch.core import CrashTester, PersistPlan, RecomputeProfile
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import CI_SIZES, ci_app, default_cache, get_app
from repro_torch.models import attention as tattn
from repro_torch.models.train_app import EVAL_KEYS, LMTrainApp, _synthetic_batch

GOLDENS = os.path.join(os.path.dirname(__file__), "golden", "campaign_goldens.json")
#: training steps whose batches the JAX sources carry: the golden run's 10
#: and every recompute up to the crash tester's budget (2 x 10 more)
TRAIN_KEYS = range(32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _jax_sources(japp):
    """The JAX app's initial parameter vector and token batches."""
    keys = list(TRAIN_KEYS) + list(EVAL_KEYS)
    batches = {k: np.asarray(jtrain._synthetic_batch(k, japp.batch, japp.seq, japp.cfg.vocab))
               for k in keys}
    return japp.init(0)["params"], batches


def _pair(dtype="bfloat16"):
    """(JAX app, port app with the JAX app's sources) at CI size."""
    kw = dict(CI_SIZES["lm-train"])
    japp = jax_get_app("lm-train", base=dataclasses.replace(jax_get_arch("stablelm-1.6b"),
                                                            dtype=dtype), **kw)
    tapp = get_app("lm-train", base=dataclasses.replace(get_arch("stablelm-1.6b"), dtype=dtype),
                   device="cpu", **kw)
    params, batches = _jax_sources(japp)
    tapp.use_sources(params=params, batches=batches)
    return japp, tapp


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


def _entry(camp):
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


# ------------------------------------------------------------ loss and grads
def test_float32_loss_and_gradient_match_jax(f32_pair):
    japp, tapp = f32_pair
    vec = japp.init(0)["params"]
    assert tapp._eval(vec) == pytest.approx(float(japp._eval(jnp.asarray(vec))), rel=1e-5, abs=1e-5)
    for k in (0, 3):
        want = np.asarray(japp._vgrad(jnp.asarray(vec), np.int32(k)))
        np.testing.assert_allclose(tapp._grad(vec, k).numpy(), want, rtol=1e-5, atol=1e-5)


def test_bfloat16_loss_and_gradient_match_jax(bf16_pair):
    japp, tapp = bf16_pair
    vec = japp.init(0)["params"]
    assert tapp._eval(vec) == pytest.approx(float(japp._eval(jnp.asarray(vec))), rel=1e-3)
    for k in (0, 3):
        want = np.asarray(japp._vgrad(jnp.asarray(vec), np.int32(k)))
        got = tapp._grad(vec, k).numpy()
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_loss_and_aux_parts(f32_pair):
    """total = nll + z_loss + 0.01 aux, aux 0 on the dense path."""
    from repro_torch.models import loss_and_aux

    _, tapp = f32_pair
    params = tapp._unflatten(torch.from_numpy(tapp.init(0)["params"]))
    total, parts = loss_and_aux(tapp.cfg, params, {"tokens": tapp._batch(0)})
    assert float(parts["moe_aux"]) == 0.0
    assert float(total) == pytest.approx(float(parts["nll"] + parts["z_loss"]), rel=1e-7)
    assert 0 < float(parts["z_loss"]) < float(parts["nll"])


# ------------------------------------------------------------------- the pin
@pytest.mark.parametrize("engine", ["ref", "vec"])
def test_campaign_with_jax_sources_reproduces_golden(bf16_pair, engine):
    _, tapp = bf16_pair
    camp = CrashTester(tapp, PersistPlan.none(), default_cache(tapp), seed=123,
                       engine=engine).run_campaign(8)
    assert _entry(camp) == _goldens()["apps"]["lm-train"]
    if engine == "ref":
        p = RecomputeProfile.from_campaign(camp)
        got = {"app": p.app_name, "fault": dict(p.fault_spec),
               "fractions": {c: float(p.fractions.get(c, 0.0)) for c in ("S1", "S2", "S3", "S4")},
               "extra_iters_hist": [[int(i), int(c)] for i, c in p.extra_iters_hist],
               "golden_iters": p.golden_iters, "n_records": p.n_records}
        assert got == _goldens()["profiles"]["lm-train"]


def test_workflow_plan_with_jax_sources_equals_jax_plan(bf16_pair):
    _, tapp = bf16_pair
    plan = run_workflow(tapp, WorkflowConfig(n_tests=24, cache=default_cache(tapp), seed=0)).plan
    assert (plan.objects, dict(plan.region_freq)) == (("params",), {})


# ------------------------------------------------------- both weight sources
def _sources(kind):
    if kind == "jax":
        return _pair("bfloat16")[1]
    return ci_app("lm-train", device="cpu")


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_batched_lanes_bitwise_equal_serial(kind):
    app = _sources(kind)
    states = []
    for n in (0, 2, 5):
        s = app.init(0)
        for _ in range(n):
            s = app.run_iteration(s)
        states.append(s)
    for s, b in zip(states, app.run_iteration_batch(states)):
        serial = app.run_iteration(s)
        for k in serial:
            assert _bits(b[k]) == _bits(serial[k]), k


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_app_pickles(kind):
    app = _sources(kind)
    clone = pickle.loads(pickle.dumps(app))
    s = app.init(0)
    assert _bits(clone.init(0)["params"]) == _bits(s["params"])
    assert _bits(clone.run_iteration(s)["params"]) == _bits(app.run_iteration(s)["params"])


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_tensor_state_steps_like_numpy_state(kind):
    app = _sources(kind)
    s = app.run_iteration(app.init(0))
    out = app.run_iteration(s)
    out_t = app.run_iteration({k: torch.from_numpy(np.array(v)) for k, v in s.items()})
    for k in out:
        assert isinstance(out_t[k], torch.Tensor) and _bits(out_t[k]) == _bits(out[k]), k


def test_campaign_with_port_weights_partitions_the_records():
    app = ci_app("lm-train", device="cpu")
    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=123).run_campaign(8)
    got = _entry(camp)
    want = _goldens()["apps"]["lm-train"]
    assert sum(got["counts"].values()) == 8
    assert got["golden_iters"] == want["golden_iters"]
    assert got["crash_iters"] == want["crash_iters"]
    assert all(np.isfinite(r.verify_metric) for r in camp.records)


# ----------------------------------------------------------------- sources
def test_synthetic_batch_is_a_seeded_learnable_stream():
    a = _synthetic_batch(3, 4, 16, 256)
    assert a.dtype == torch.int32 and a.shape == (4, 17)
    assert torch.equal(a, _synthetic_batch(3, 4, 16, 256))
    assert not torch.equal(a, _synthetic_batch(4, 4, 16, 256))
    assert int(a.min()) >= 0 and int(a.max()) < 256
    follows = (a[:, 1:] == (a[:, :-1] * 7 + 3) % 256).float().mean()
    assert 0.6 < float(follows) < 1.0


def test_use_sources_checks_and_missing_keys_raise():
    app = ci_app("lm-train", device="cpu")
    with pytest.raises(ValueError, match="parameter vector"):
        app.use_sources(params=np.zeros(3, np.float32))
    app.use_sources(batches={0: np.zeros((2, 17), np.int32)})
    app._grad(app.init(0)["params"], 0)
    with pytest.raises(KeyError):
        app._grad(app.init(0)["params"], 1)


def test_registry_builds_the_port_app():
    app = get_app("lm-train", n_iters=4, batch=2, seq=8, width=32, device="cpu")
    assert isinstance(app, LMTrainApp) and app.name == "lm-train"


# ------------------------------------------------------- chunked attention
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("s,chunk", [(64, 16), (32, 32), (48, 512)])
def test_attention_chunked_matches_jax(s, chunk, window):
    rng = np.random.default_rng(s + chunk)
    q, k, v = (rng.standard_normal((2, s, 3, 16)).astype(np.float32) for _ in range(3))
    want = jattn._attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window, chunk=chunk)
    got = tattn._attention_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                   window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_full_chunked_matches_reference():
    from repro_torch.models import scaled_down

    cfg = scaled_down(get_arch("stablelm-1.6b"), width=64)
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = tattn.attn_params(cfg, gen, 1)
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 32, cfg.d_model, generator=gen)
    pos = torch.arange(32, dtype=torch.int32)
    want = tattn.attention_full(p, x, cfg, pos, window=8, impl="reference")
    got = tattn.attention_full(p, x, cfg, pos, window=8, impl="chunked")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
