"""Heads padded to a mesh axis's split (models/padding.py) against the
JAX package's unpadded model, on the CPU with plain tensors.

The production meshes' 16-way "model" axis does not divide 40 or 24 heads;
the dry-run places parameters padded to whole heads per device, as XLA pads
them.  At a narrow width the same padding, to a split of 4: a GQA config of
10 q heads over 2 kv heads (2 groups of 5, padded to 6: 12 heads) and an
RWKV-6 config of 10 heads of 16 (padded to 12).  Both packages get JAX's
weights (``params_from_jax``); the port's padded model must give JAX's
unpadded logits within 1e-5 in float32 (of the largest logit), through the
full-sequence forward and through a prefill and three greedy decode steps;
every padded head's output before the output projection is exactly 0, as
is RWKV's padded decode state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import scaled_down as jax_scaled_down
from repro.launch.serve import _splice_cache as jax_splice_cache
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import attention, decode_step, forward, init_cache, prefill, rwkv6
from repro_torch.models import scaled_down
from repro_torch.models.padding import (attn_heads, pad_cache, pad_heads, pad_params,
                                        q_groups, rwkv_heads, unpad_heads)

SPLIT, TOL = 4, 1e-5
#: name -> (base arch, width, overrides), each at float32
CASES = {
    "gqa": ("granite-8b", 80, dict(n_heads=10, n_kv_heads=2, d_head=8)),
    "rwkv": ("rwkv6-3b", 160, {}),
}
#: the padded heads' indices among the 12
PADDED = {"gqa": [5, 11], "rwkv": [10, 11]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(name):
    arch, width, over = CASES[name]
    j = dataclasses.replace(jax_scaled_down(jax_get_arch(arch), width=width), dtype="float32",
                            **over)
    t = dataclasses.replace(scaled_down(get_arch(arch), width=width), dtype="float32", **over)
    return j.validate(), t.validate()


def _model(name):
    jcfg, tcfg = _cfgs(name)
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, pad_params(tcfg, params_from_jax(jp, "cpu"), SPLIT)


def _tokens(cfg, b, s):
    return np.random.default_rng(3).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def _recording_pre_projection(monkeypatch, name) -> list:
    seen = []
    module = attention if name == "gqa" else rwkv6
    real = module.heads_merged

    def merged(x):
        seen.append(x.detach().clone())
        return real(x)

    monkeypatch.setattr(module, "heads_merged", merged)
    return seen


def test_padded_head_counts_and_layouts():
    """40 -> 48 over 16 in groups of 5 -> 6 (Scout), 24 -> 32 after the last
    head (musicgen), 40 -> 48 (RWKV6-3B); a split that divides, none;
    pad_heads and unpad_heads invert each other."""
    scout, musicgen, rwkv = (get_arch(a) for a in ("llama4-scout-17b-a16e", "musicgen-medium",
                                                   "rwkv6-3b"))
    assert attn_heads(scout, 16) == 48 and q_groups(scout, 48) == (8, 5, 6)
    assert attn_heads(musicgen, 16) == 32 and q_groups(musicgen, 32) == (1, 24, 32)
    assert rwkv_heads(rwkv, 16) == 48
    assert attn_heads(scout, 8) == 40 and attn_heads(get_arch("stablelm-1.6b"), 16) == 32
    x = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10 * 3) + 1
    p = pad_heads(x, 1, 2, 5, 6)
    assert tuple(p.shape) == (2, 36) and not p[:, 15:18].any() and not p[:, 33:].any()
    assert torch.equal(unpad_heads(p, 1, 2, 5, 6), x)


@pytest.mark.parametrize("name", list(CASES))
def test_padded_forward_matches_jax(name, monkeypatch):
    jcfg, tcfg, jp, padded = _model(name)
    toks = _tokens(jcfg, 2, 16)
    want, _ = jax_forward(jcfg, jp, jnp.asarray(toks))
    seen = _recording_pre_projection(monkeypatch, name)
    got, _ = forward(tcfg, padded, torch.from_numpy(toks))
    _close(got, want)
    assert len(seen) == tcfg.n_layers
    for out in seen:
        assert out.shape[-2] == 12 and not out[..., PADDED[name], :].any()


@pytest.mark.parametrize("name", list(CASES))
def test_padded_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jp, padded = _model(name)
    b, s, steps = 2, 16, 3
    toks = _tokens(jcfg, b, s)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks))
    jcache = jax_splice_cache(jcfg, jax_init_cache(jcfg, b, s + steps + 1), jc, s)
    tl, tc = prefill(tcfg, padded, torch.from_numpy(toks))
    _close(tl, jl)
    empty = pad_cache(tcfg, init_cache(tcfg, b, s + steps + 1, device="cpu"), SPLIT)
    tcache = serve._splice_cache(tcfg, empty, tc, s)
    token = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for _ in range(steps):
        jl, jcache = jax_decode_step(jcfg, jp, jnp.asarray(token), jcache)
        tl, tcache = decode_step(tcfg, padded, torch.from_numpy(token), tcache)
        _close(tl, jl)
        token = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    if name == "rwkv":
        S = tcache["group0"]["pos0"]["S"]
        assert S.shape[2] == 12 and not S[:, :, 10:].any()
