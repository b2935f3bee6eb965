"""The port's chunked implementations against the JAX package's and against
the step-by-step oracle, on the CPU: chunked RWKV-6 (both layouts, and the
state its chunk loop carries out), and ``forward(..., impl="chunked")`` for
the attention, RWKV-6 and RG-LRU layer kinds.

Tolerances: the chunked RWKV-6 form takes bfloat16 operands in its products
(f32 sums), so against the exact recurrence it is held to
tests/test_chunked_impls.py's 2e-2 of the largest entry.  Against JAX's own
chunked functions, which round at the same places, to 2e-3 of the largest
entry: XLA's f32 exp, log and cumsum differ from torch's in the last bit,
and an operand on the other side of a bfloat16 rounding boundary moves its
product by a bfloat16 ulp (2^-8 relative; over 8 seeds and chunks 32-128
the largest difference seen was 6.6e-4 of the largest entry).  The f32
models are held to 1e-4 (abs and rel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.rwkv6_scan.ref import rwkv6_reference as jax_rwkv6_reference
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import rwkv6 as jax_rwkv6
from repro.models import scaled_down as jax_scaled_down
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference
from repro_torch.models import forward, init_params, rwkv6, scaled_down

F32_TOL, CHUNKED_REL, JAX_CHUNKED_REL = 1e-4, 2e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rwkv_inputs(b=2, h=3, t=256, d=32, seed=1):
    """r, k, v, w (B, H, T, D) and u (H, D): the model's decay
    parameterization, w = exp(-exp(-6 + 0.5 N(0, 1)))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((b, h, t, d)))).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _swap(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_chunked_rwkv_matches_ref_realistic_decay(chunk):
    """tests/test_chunked_impls.py's case, on the port's oracle and JAX's."""
    xs = _rwkv_inputs()
    got, state = rwkv6.rwkv_chunked_bhtd(*map(torch.from_numpy, xs), chunk=chunk,
                                         return_state=True)
    want, want_state = rwkv6_reference(*map(torch.from_numpy, xs), return_state=True)
    assert _rel(got.numpy(), want.numpy()) < CHUNKED_REL
    assert _rel(got.numpy(), np.asarray(jax_rwkv6_reference(*map(jnp.asarray, xs)))) < CHUNKED_REL
    assert _rel(state.numpy(), want_state.numpy()) < CHUNKED_REL


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_chunked_rwkv_both_layouts_match_jax(chunk):
    """rwkv_chunked_bhtd and the (B, S, H, D) _rwkv_chunked against JAX's
    own, and the two layouts' final states against each other."""
    xs = _rwkv_inputs(seed=2)
    want = np.asarray(jax_rwkv6.rwkv_chunked_bhtd(*map(jnp.asarray, xs), chunk=chunk))
    got, state = rwkv6.rwkv_chunked_bhtd(*map(torch.from_numpy, xs), chunk=chunk,
                                         return_state=True)
    assert _rel(got.numpy(), want) < JAX_CHUNKED_REL
    r, k, v, w, u = xs
    bshd = [_swap(x) for x in (r, k, v, w)] + [u]
    want2 = np.asarray(jax_rwkv6._rwkv_chunked(*map(jnp.asarray, bshd), chunk=chunk))
    got2, state2 = rwkv6._rwkv_chunked(*map(torch.from_numpy, bshd), chunk=chunk,
                                       return_state=True)
    assert _rel(got2.numpy(), want2) < JAX_CHUNKED_REL
    np.testing.assert_allclose(state2.numpy(), state.numpy(), atol=F32_TOL, rtol=F32_TOL)
    assert rwkv6._rwkv_chunked(*map(torch.from_numpy, bshd), chunk=chunk).shape == got2.shape


def test_chunked_rwkv_ragged_length():
    """A length shorter than the chunk runs as one chunk; a longer one that
    is not a multiple of it asserts, as JAX's does."""
    r, k, v, w, u = _rwkv_inputs(t=96, seed=3)
    bshd = [torch.from_numpy(_swap(x)) for x in (r, k, v, w)] + [torch.from_numpy(u)]
    want = jax_rwkv6._rwkv_chunked(*(jnp.asarray(x.numpy()) for x in bshd), chunk=128)
    got = rwkv6._rwkv_chunked(*bshd, chunk=128)
    assert _rel(got.numpy(), np.asarray(want)) < JAX_CHUNKED_REL
    with pytest.raises(AssertionError):
        rwkv6._rwkv_chunked(*bshd, chunk=64)


def test_chunked_state_matches_jax_state_after():
    """The state the chunk loop carries out of a scaled RWKV-6 layer against
    JAX's exact _rwkv_state_after (two chunks of 128)."""
    jcfg = dataclasses.replace(jax_scaled_down(jax_get_arch("rwkv6-3b"), width=64),
                               dtype="float32")
    tcfg = dataclasses.replace(scaled_down(get_arch("rwkv6-3b"), width=64), dtype="float32")
    jp = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax_init_params(jcfg, jax.random.PRNGKey(4))["group0"]["pos0"]["rwkv"])
    x = np.random.default_rng(8).standard_normal((2, 256, 64)).astype(np.float32)
    want = jax_transformer._rwkv_state_after(jcfg, jp, jnp.asarray(x))
    out, state = rwkv6.rwkv_scan_full(params_from_jax(jp, "cpu"), torch.from_numpy(x), tcfg,
                                      impl="chunked", return_state=True)
    assert _rel(state["S"].numpy(), np.asarray(want["S"])) < CHUNKED_REL
    np.testing.assert_array_equal(state["x_last"].numpy(), np.asarray(want["x_last"]))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_rwkv6.rwkv_scan_full(jp, jnp.asarray(x), jcfg,
                                                         impl="chunked")),
        atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b", "recurrentgemma-9b"])
def test_forward_chunked_matches_jax(arch):
    """forward(..., impl="chunked") on each layer kind: the port's against
    JAX's at 1e-4 in f32.  On RecurrentGemma JAX's impl="chunked" runs its
    associative scan, the port's its plain scan."""
    jcfg = dataclasses.replace(jax_scaled_down(jax_get_arch(arch), width=64), dtype="float32")
    tcfg = dataclasses.replace(scaled_down(get_arch(arch), width=64), dtype="float32")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    want, _ = jax_forward(jcfg, jp, jnp.asarray(toks), impl="chunked")
    got, _ = forward(tcfg, params_from_jax(jp, "cpu"), torch.from_numpy(toks), impl="chunked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_unknown_impl_names_raise():
    tcfg = dataclasses.replace(scaled_down(get_arch("recurrentgemma-9b"), width=64),
                               dtype="float32")
    params = init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunked"):
        forward(tcfg, params, torch.zeros((1, 8), dtype=torch.int32), impl="pallas")
