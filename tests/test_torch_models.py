"""The port's dense model stack against the JAX package's, on the CPU.

Both packages get the same weights: JAX's ``init_params`` converted leaf for
leaf by ``params_from_jax``.  Tolerances: 1e-4 (abs and rel) for a float32
config, where the two differ only in the order of f32 sums; bfloat16 is held
to equality where the two frameworks round at the same places (the SiLU
written op by op, the greedy token stream).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.serve import _splice_cache as jax_splice_cache
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import scaled_down as jax_scaled_down
from repro.models.layers import activation_fn as jax_activation_fn
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import _splice_cache
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill, scaled_down
from repro_torch.models.attention import attention_full
from repro_torch.models.layers import activation_fn, rms_norm

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(dtype):
    jcfg = jax_scaled_down(jax_get_arch("stablelm-1.6b"), width=64)
    tcfg = scaled_down(get_arch("stablelm-1.6b"), width=64)
    return (dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype))


def _weights(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jp, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bits(x) -> np.ndarray:
    """bfloat16 values of either framework as their uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_params_from_jax_is_byte_exact():
    jcfg, _ = _cfgs("bfloat16")
    jp, tp = _weights(jcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == (torch.bfloat16 if leaf.dtype.name == "bfloat16" else t.dtype)
        assert _bits(t).tobytes() == leaf.view(np.uint16).tobytes()


def test_init_params_layout_matches_jax():
    """The port's own random weights have JAX's tree, shapes and dtypes."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    again = init_params(tcfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], tp["embed"])


def test_forward_f32_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg)
    toks = _tokens(jcfg, 2, 16)
    want, _ = jax_forward(jcfg, jp, jnp.asarray(toks))
    got, aux = forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_f32_match_jax():
    """prefill logits and cache, then 8 greedy decode steps, to 1e-4."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg)
    b, s, steps = 2, 8, 8
    max_len = s + steps + 1
    toks = _tokens(jcfg, b, s)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks))
    tl, tc = prefill(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tc["group0"]["pos0"][kv]),
                                   np.asarray(jc["group0"]["pos0"][kv]),
                                   atol=F32_TOL, rtol=F32_TOL)
    assert int(tc["t"]) == int(jc["t"]) == s

    jcache = jax_splice_cache(jcfg, jax_init_cache(jcfg, b, max_len), jc, s)
    tcache = _splice_cache(tcfg, init_cache(tcfg, b, max_len, device="cpu"), tc, s)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        jlog, jcache = jstep(jp, jtok, jcache)
        # both sides are fed JAX's token, so a near tie cannot fork the streams
        tlog, tcache = decode_step(tcfg, tp, torch.from_numpy(np.asarray(jtok)), tcache)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=F32_TOL, rtol=F32_TOL)
        jtok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
    assert int(tcache["t"]) == int(jcache["t"]) == s + steps
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["group0"]["pos0"][kv]),
                                   np.asarray(jcache["group0"]["pos0"][kv]),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_bf16_silu_matches_jax_bitwise():
    h = np.random.default_rng(0).standard_normal((4, 16, 192)).astype(np.float32) * 3
    u = np.random.default_rng(1).standard_normal((4, 16, 192)).astype(np.float32)
    jh, ju = jnp.asarray(h, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16)
    want = jax.jit(lambda a, b: jax_activation_fn("silu")(a) * b)(jh, ju)
    th, tu = torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(u).to(torch.bfloat16)
    assert _bits(th).tobytes() == _bits(jh).tobytes()
    got = activation_fn("silu")(th) * tu
    assert np.array_equal(_bits(got), _bits(want))


def test_rms_norm_bf16_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 8, 64)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal(64).astype(np.float32) * 0.1
    want = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), 1e-5)
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(g).to(torch.bfloat16), 1e-5)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bf16_greedy_stream_matches_jax():
    """12 greedy tokens in the model's own bfloat16 equal JAX's."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _weights(jcfg)
    b, s, steps = 2, 8, 12
    max_len = s + steps + 1
    toks = _tokens(jcfg, b, s, seed=5)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks))
    jcache = jax_splice_cache(jcfg, jax_init_cache(jcfg, b, max_len), jc, s)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    jstream = [np.asarray(jtok)]
    for _ in range(steps):
        jlog, jcache = jstep(jp, jtok, jcache)
        jtok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
        jstream.append(np.asarray(jtok))

    tl, tc = prefill(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))
    tcache = _splice_cache(tcfg, init_cache(tcfg, b, max_len, device="cpu"), tc, s)
    ttok = tl.argmax(dim=-1).to(torch.int32)[:, None]
    tstream = [ttok.numpy()]
    for _ in range(steps):
        tlog, tcache = decode_step(tcfg, tp, ttok, tcache)
        ttok = tlog[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        tstream.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(tstream, 1), np.concatenate(jstream, 1))


def test_out_of_range_token_embeds_as_nan_like_jax():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg)
    ids = np.array([[-1, jcfg.vocab, 3, -jcfg.vocab - 1]], np.int32)
    want, _ = jax_forward(jcfg, jp, jnp.asarray(ids))
    got, _ = forward(tcfg, tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(np.isnan(_np(got)), np.isnan(np.asarray(want)))
    np.testing.assert_allclose(_np(got)[0, 0], np.asarray(want)[0, 0], atol=F32_TOL, rtol=F32_TOL)


def test_unported_paths_name_their_roadmap_item():
    """Module item 7 is ported: an MoE config builds and runs (its parity
    with JAX: tests/test_torch_moe.py, tests/test_torch_arch_smoke.py)."""
    cfg = scaled_down(get_arch("qwen2-moe-a2.7b"), width=64)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert "moe" in params["group0"]["pos0"] and "mlp" not in params["group0"]["pos0"]
    logits, aux = forward(cfg, params, torch.zeros((1, 32), dtype=torch.int32))
    assert logits.shape == (1, 32, cfg.vocab) and float(aux) > 0
    _, tcfg = _cfgs("float32")
    x = torch.zeros(1, 8, tcfg.d_model)
    p = {k: torch.zeros(tcfg.d_model, tcfg.d_model) for k in ("wq", "wk", "wv", "wo")}
    # impl="chunked" is ported now (tests/test_torch_train.py); a name the
    # port does not know still raises
    with pytest.raises(ValueError, match="chunked"):
        attention_full(p, x, tcfg, torch.arange(8), impl="flash")
    assert attention_full(p, x, tcfg, torch.arange(8), impl="chunked").shape == x.shape
