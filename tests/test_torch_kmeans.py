"""The port's k-means against the JAX package's, on the CPU.

The squared distances sum over the dimensions one term at a time, each
added by one fused multiply-add, as XLA computes them: the distances and
the assignment are bitwise JAX's.  The centroid update's one-hot product
and the inertia's sum have other orders than XLA's and agree to a
relative 1e-6; the counts are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import kmeans as jkm
from repro.hpc.suite import ci_app as jax_ci_app
from repro_torch.hpc import kmeans as tkm
from repro_torch.hpc.suite import ci_app

RTOL = 1e-6


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


def _state(n):
    app = jax_ci_app("kmeans")
    s = app.init(0)
    for _ in range(n):
        s = app.run_iteration(s)
    return s


@pytest.mark.parametrize("n", [0, 2, 7])
def test_assign_bitwise_equal_jax(n):
    s = _state(n)
    p, c = s["points"], s["centroids"]
    # _assign's distances, as its jit compiles them
    want_d2 = jax.jit(lambda p, c: jnp.sum((p[:, None, :] - c[None, :, :]) ** 2, axis=-1))(p, c)
    got_d2 = tkm._sq_dist(torch.tensor(p), torch.tensor(c))
    assert _bits(got_d2) == _bits(np.asarray(want_d2))
    want = jkm._assign(jnp.asarray(p), jnp.asarray(c))
    assert _bits(tkm._assign(torch.tensor(p), torch.tensor(c))) == _bits(want)


def test_argmin_takes_the_first_minimum():
    p = torch.zeros((3, 2))
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    assert tkm._assign(p, c).tolist() == [0, 0, 0]
    assert np.asarray(jkm._assign(jnp.zeros((3, 2)), jnp.asarray(c.numpy()))).tolist() == [0, 0, 0]


@pytest.mark.parametrize("n", [0, 2, 7])
def test_update_and_inertia_within_rtol_of_jax(n):
    s = jax_ci_app("kmeans")._region_assign(_state(n))
    p, a, c = s["points"], s["assign"], s["centroids"]
    want = np.asarray(jkm._update(jnp.asarray(p), jnp.asarray(a), jnp.asarray(c), 12))
    got = tkm._update(torch.tensor(p), torch.tensor(a), torch.tensor(c), 12).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    want_i = float(jkm._inertia(jnp.asarray(p), jnp.asarray(c)))
    got_i = float(tkm._inertia(torch.tensor(p), torch.tensor(c)))
    assert abs(got_i - want_i) <= RTOL * want_i


def test_empty_cluster_keeps_its_centroid():
    p = torch.tensor([[0.0, 0.0], [1.0, 1.0]])
    c = torch.tensor([[0.0, 0.0], [1.0, 1.0], [9.0, 9.0]])
    out = tkm._update(p, tkm._assign(p, c), c, 3)
    assert out.tolist() == c.tolist()


def test_golden_inertia_is_cached_and_close_to_jax():
    japp, tapp = jax_ci_app("kmeans"), ci_app("kmeans", device="cpu")
    got = tapp._golden_target()
    assert tapp._golden_inertia == got
    assert abs(got - japp._golden_target()) <= RTOL * japp._golden_target()
