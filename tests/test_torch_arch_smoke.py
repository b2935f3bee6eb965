"""Per-architecture smoke tests of the port, on the CPU: the port of
tests/test_arch_smoke.py over all ten registered archs at ``scaled_down``.

Each arch's forward is held to the JAX package's on the same weights (JAX's
``init_params`` converted leaf for leaf) at 1e-4 (abs and rel) in float32,
with the MoE aux loss; the train step, the decode step, the registry and the
exact configs are the JAX test's checks on the port.  For the two MoE archs,
prefill plus 4 greedy decode steps give JAX's tokens, in float32 and in the
model's own bfloat16 (JAX's decode step jitted, as it is served).
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
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import _splice_cache
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill, scaled_down
from repro_torch.optim.adamw import tree_leaves

ALL = sorted(ARCHS)
MOE = ("llama4-scout-17b-a16e", "qwen2-moe-a2.7b")
F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(name, dtype=None):
    jcfg, tcfg = jax_scaled_down(jax_get_arch(name)), scaled_down(get_arch(name))
    if dtype:
        jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _patches(cfg, b, seed=2):
    if not cfg.frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", ALL)
def test_forward_f32_matches_jax(name):
    jcfg, tcfg = _cfgs(name, "float32")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    b, s = 2, 16
    toks, patches = _tokens(jcfg, b, s), _patches(jcfg, b)
    want, want_aux = jax_forward(jcfg, jp, jnp.asarray(toks),
                                 None if patches is None else jnp.asarray(patches))
    got, aux = forward(tcfg, params_from_jax(jp, "cpu"), torch.from_numpy(toks),
                       None if patches is None else torch.from_numpy(patches))
    assert got.shape == (b, s + tcfg.frontend_tokens, tcfg.vocab)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=F32_TOL, rtol=F32_TOL)
    assert (float(aux) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("name", ALL)
def test_train_step_no_nans(name):
    _, cfg = _cfgs(name)
    step = make_train_step(cfg, peak_lr=1e-3, total_steps=10)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 17, seed=3))}
    patches = _patches(cfg, 2, seed=3)
    if patches is not None:
        batch["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_state["step"]) == 1
    # parameters actually moved
    before, after = tree_leaves(state["params"]), tree_leaves(new_state["params"])
    assert not torch.equal(before[1], after[1])
    for leaf in after:
        assert torch.isfinite(leaf.float()).all()


@pytest.mark.parametrize("name", ALL)
def test_decode_step_shapes(name):
    _, cfg = _cfgs(name)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    b = 2
    cache = init_cache(cfg, b, max_len=32, device="cpu")
    token = torch.from_numpy(_tokens(cfg, b, 1, seed=4))
    logits, new_cache = decode_step(cfg, params, token, cache)
    assert logits.shape == (b, 1, cfg.vocab)
    assert int(new_cache["t"]) == 1
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_and_greedy_decode_give_jax_tokens(name, dtype):
    """Prefill (the sort route, 32 dispatch groups) and 4 greedy decode steps
    (the dense route): each package's own stream, and they are equal; in
    float32 each step's logits agree to 1e-4 too."""
    jcfg, tcfg = _cfgs(name, dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(5)))
    tp = params_from_jax(jp, "cpu")
    b, s, steps = 2, 16, 4
    max_len = s + steps + 1
    toks = _tokens(jcfg, b, s, seed=6)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks))
    jcache = jax_splice_cache(jcfg, jax_init_cache(jcfg, b, max_len), jc, s)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    jstream, jlogits = [np.asarray(jtok)], []
    for _ in range(steps):
        jlog, jcache = jstep(jp, jtok, jcache)
        jtok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
        jstream.append(np.asarray(jtok))
        jlogits.append(np.asarray(jlog))

    tl, tc = prefill(tcfg, tp, torch.from_numpy(toks))
    if dtype == "float32":
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    tcache = _splice_cache(tcfg, init_cache(tcfg, b, max_len, device="cpu"), tc, s)
    ttok = tl.argmax(dim=-1).to(torch.int32)[:, None]
    tstream = [ttok.numpy()]
    for want in jlogits:
        tlog, tcache = decode_step(tcfg, tp, ttok, tcache)
        if dtype == "float32":
            np.testing.assert_allclose(tlog.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
        ttok = tlog[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        tstream.append(ttok.numpy())
    assert int(tcache["t"]) == s + steps
    np.testing.assert_array_equal(np.concatenate(tstream, 1), np.concatenate(jstream, 1))


def test_all_archs_registered():
    assert len(ALL) == 10
    assert set(ALL) == {
        "musicgen-medium", "minitron-8b", "granite-8b", "stablelm-1.6b",
        "nemotron-4-340b", "recurrentgemma-9b", "rwkv6-3b",
        "llama4-scout-17b-a16e", "qwen2-moe-a2.7b", "internvl2-76b",
    }


def test_exact_assigned_configs():
    """The full configs carry the exact assigned hyper-parameters, and equal
    the JAX package's."""
    expect = {
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
        "minitron-8b": (32, 4096, 32, 8, 16384, 256000),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "stablelm-1.6b": (24, 2048, 32, 32, 5632, 100352),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "qwen2-moe-a2.7b": (24, 2048, 16, 16, 1408, 151936),
        "internvl2-76b": (80, 8192, 64, 8, 28672, 128256),
    }
    for name, (L, d, hq, hkv, ff, V) in expect.items():
        cfg = get_arch(name)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                cfg.vocab) == (L, d, hq, hkv, ff, V), name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_arch(name)), name
    q = get_arch("qwen2-moe-a2.7b").moe
    assert q.num_experts == 60 and q.top_k == 4 and q.d_ff_shared == 5632
    assert q.d_ff_expert == 1408 and q.dispatch_groups == 32
    l4 = get_arch("llama4-scout-17b-a16e").moe
    assert l4.num_experts == 16 and l4.top_k == 1 and l4.d_ff_shared == 8192
    rg = get_arch("recurrentgemma-9b")
    assert rg.total_layers() == 38 and rg.attn_window == 2048
