"""The port's optimizer (repro_torch.optim) against the JAX package's, on
the CPU, on the same numpy-seeded inputs.

Tolerances:
* adamw_update at float32, unclipped: bit for bit (held to 1 ulp), after 1
  and 3 steps.  XLA's CPU backend contracts none of AdamW's sums, so each
  op rounds once in both packages.
* clipped: the clip scale divides by the global norm, whose float32 sum
  XLA orders its own way (grad_norm held to 1e-6 relative); a last-bit
  difference in the scale moves every element, so after 3 clipped steps
  each leaf is held to 1e-6 of its largest magnitude.
* bfloat16 parameters (float32 and bfloat16 moments): bit for bit.
* linear_warmup over steps 0-300: 1 float32 ulp.  cosine_schedule: 4
  ulps.  XLA's float32 cos and torch's are each within an ulp of the true
  cosine but not always the same float; near the end of the decay
  ``1 + cos`` cancels, which scales that ulp up to about 3 of the result.
* quantize_int8: exact; compress_topk / decompress_topk: exact on distinct
  magnitudes (jax.lax.top_k and torch.topk order ties their own ways).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro.optim import schedule as jax_sched
from repro_torch.convert import host_array, to_tensor
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_topk,
    cosine_schedule,
    decompress_topk,
    dequantize_int8,
    linear_warmup,
    quantize_int8,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two float arrays
    of one dtype (float32, or bfloat16 as its 16 bits)."""
    ints = {4: np.int32, 2: np.int16}[a.dtype.itemsize]
    ia = a.view(ints).astype(np.int64)
    ib = b.view(ints).astype(np.int64)
    # sign-magnitude to a monotone integer line
    ia = np.where(ia < 0, np.iinfo(ints).min - ia, ia)
    ib = np.where(ib < 0, np.iinfo(ints).min - ib, ib)
    return int(np.abs(ia - ib).max()) if a.size else 0


def _tree(rng, dtype, scale=1.0):
    mk = lambda shape: (rng.standard_normal(shape) * scale).astype(np.float32)
    tree = {"a": mk((48, 33)), "b": {"c": mk((1000,)), "d": mk((7, 5, 3))}}
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), tree)
    return tree


def _torch_tree(tree):
    return jax.tree.map(lambda x: to_tensor(x, "cpu"), tree)


def _host(tree):
    return jax.tree.map(lambda x: host_array(x), tree)


def _jax_host(tree):
    """A JAX tree as the port's host arrays (bfloat16 as int16 bits)."""
    def one(x):
        x = np.asarray(x)
        return x.view(np.int16) if x.dtype.kind == "V" or x.dtype.name == "bfloat16" else x
    return jax.tree.map(one, tree)


def _run_both(dtype, moment_dtype, grad_scale, steps, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    js, ts = jax_adamw.adamw_init(jp, moment_dtype), adamw_init(tp, moment_dtype)
    norms = []
    for _ in range(steps):
        g = _tree(rng, dtype, grad_scale)
        lr = np.float32(1e-2)
        jp, js, jst = jax_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jnp.asarray(lr))
        tp, ts, tst = adamw_update(tp, _torch_tree(g), ts, torch.tensor(lr))
        norms.append((float(jst["grad_norm"]), float(tst["grad_norm"])))
    pairs = [(jp, tp), (js["mu"], ts["mu"]), (js["nu"], ts["nu"])]
    leaves = []
    for j, t in pairs:
        leaves += list(zip(jax.tree.leaves(_jax_host(j)), jax.tree.leaves(_host(t))))
    assert int(js["count"]) == int(ts["count"]) == steps
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    return leaves, norms


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_f32_unclipped_matches_jax_to_one_ulp(steps):
    leaves, norms = _run_both("float32", "float32", 1e-3, steps)
    for a, b in leaves:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _ulps(a, b) <= 1
    for want, got in norms:
        assert got == pytest.approx(want, rel=1e-6) and want < 1.0  # unclipped


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_f32_clipped_matches_jax(steps):
    leaves, norms = _run_both("float32", "float32", 1.0, steps)
    for want, got in norms:
        assert got == pytest.approx(want, rel=1e-6) and want > 1.0  # clipped
    for a, b in leaves:
        if steps == 1:
            assert _ulps(a, b) <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_bf16_params_match_jax(moment_dtype, steps):
    leaves, norms = _run_both("bfloat16", moment_dtype, 1e-2, steps)
    for a, b in leaves:
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert _ulps(a, b) == 0
    for want, got in norms:
        assert got == pytest.approx(want, rel=1e-6)


def test_schedules_match_jax_over_steps():
    for step in range(0, 301):
        for warmup, total, peak in ((100, 300, 1.0), (7, 250, 3e-4), (0, 1, 2e-2)):
            s = torch.tensor(step, dtype=torch.int32)
            want = np.asarray(jax_sched.cosine_schedule(jnp.asarray(step, jnp.int32),
                                                        warmup, total, peak), np.float32)
            got = cosine_schedule(s, warmup, total, peak)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert _ulps(want.reshape(1), got.numpy().reshape(1)) <= 4, (step, warmup)
            want = np.asarray(jax_sched.linear_warmup(jnp.asarray(step, jnp.int32),
                                                      warmup, peak), np.float32)
            got = linear_warmup(s, warmup, peak)
            assert _ulps(want.reshape(1), got.numpy().reshape(1)) <= 1, (step, warmup)


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 257), (2, 4096)])
def test_quantize_int8_matches_jax_exactly(seed, n):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 3
    g[:4] = [0.5, -0.5, 1.5, 2.5]  # halves: both round to even
    jq, js = jax_comp.quantize_int8(jnp.asarray(g))
    tq, ts = quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(dequantize_int8(tq, ts, torch.float32).numpy(),
                                  np.asarray(jax_comp.dequantize_int8(jq, js, jnp.float32)))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_matches_jax_on_distinct_magnitudes(frac):
    rng = np.random.default_rng(3)
    mags = rng.permutation(np.arange(1, 1201, dtype=np.float32)) / 64.0
    g = (mags * rng.choice([-1.0, 1.0], mags.size).astype(np.float32)).reshape(40, 30)
    jv, ji, jr = jax_comp.compress_topk(jnp.asarray(g), frac)
    tv, ti, tr = compress_topk(torch.from_numpy(g), frac)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    back = decompress_topk(tv, ti, g.shape, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_comp.decompress_topk(jv, ji, g.shape, jnp.float32)))


# ------------------------------------------- ports of tests/test_optim.py
def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, stats = adamw_update(params, grads, state, lr=0.1, cfg=cfg)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state["count"]) == 200


def test_adamw_clips_gradients():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, _, stats = adamw_update(params, {"w": torch.full((4,), 1e6)}, state, lr=0.0)
    assert float(stats["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_adamw_bf16_moments():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = adamw_init(params, moment_dtype="bfloat16")
    assert state["mu"]["w"].dtype == torch.bfloat16
    new_p, new_s, _ = adamw_update(params, {"w": torch.ones(4, dtype=torch.bfloat16)},
                                   state, lr=1e-3)
    assert new_s["mu"]["w"].dtype == torch.bfloat16
    assert new_p["w"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    warm = float(cosine_schedule(torch.tensor(0), 100, 1000, 1.0))
    peak = float(cosine_schedule(torch.tensor(100), 100, 1000, 1.0))
    end = float(cosine_schedule(torch.tensor(1000), 100, 1000, 1.0))
    assert warm < 0.05 and peak == pytest.approx(1.0, abs=0.02)
    assert end == pytest.approx(0.1, abs=0.02)  # floor_frac


@given(seed=st.integers(0, 1000), n=st.integers(8, 512))
@settings(max_examples=25, deadline=None, derandomize=True)
def test_int8_quantization_bounded_error(seed, n):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    q, s = quantize_int8(g)
    back = dequantize_int8(q, s, g.dtype)
    max_err = float((back - g).abs().max())
    assert max_err <= float(s) * 0.5 + 1e-7  # half-ULP of the quant grid


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    vals, idx, residual = compress_topk(g, frac=0.4)  # k = 2
    back = decompress_topk(vals, idx, g.shape, g.dtype)
    np.testing.assert_allclose(back.numpy(), [0, -5.0, 0, 3.0, 0], atol=1e-6)
    np.testing.assert_allclose(residual.numpy(), [0.1, 0, 0.2, 0, -0.05], atol=1e-6)
    np.testing.assert_allclose((back + residual).numpy(), g.numpy(), atol=1e-6)


@pytest.mark.parametrize("compression", [None, "int8", "topk:0.1"])
def test_train_step_with_compression(compression):
    """The JAX test's case in the port, and the loss beside JAX's jitted
    step on the same state and batch, to 1e-6 relative (XLA fuses the loss
    into the gradient's program and may round its float32 sums apart from
    the forward alone: a last-bit difference).  JAX's top-k step runs
    unjitted: the reference's decompress_topk calls int() on a traced
    shape product, which jit refuses."""
    from repro.configs import get_arch as jax_get_arch
    from repro.launch.steps import init_train_state as jax_init_train_state
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import scaled_down as jax_scaled_down
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_from_jax
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import scaled_down

    cfg = scaled_down(get_arch("stablelm-1.6b"))
    jcfg = jax_scaled_down(jax_get_arch("stablelm-1.6b"))
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    state = train_state_from_jax(jstate, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    step = make_train_step(cfg, grad_compression=compression, total_steps=5)
    new_state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(metrics["loss"]))
    for leaf in jax.tree.leaves(new_state["params"]):
        assert torch.isfinite(leaf.float()).all()
    jstep = jax_make_train_step(jcfg, grad_compression=compression, total_steps=5)
    if compression is None or not compression.startswith("topk"):
        jstep = jax.jit(jstep)
    _, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(metrics["lr"]) == float(jm["lr"])
