"""The port's PageRank against the JAX package's, on the CPU.

The damped update is bitwise JAX's (XLA contracts ``damping * y + c`` into
one fused multiply-add; the port's torch.addcmul rounds once the same way).
The spmv and the sums are not: the product has the BLAS's order and the sums
``tree_sum``'s, so they agree to a relative 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import pagerank as jpr
from repro.hpc.suite import ci_app as jax_ci_app
from repro_torch.hpc import pagerank as tpr
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


def _state(n_iters):
    app = jax_ci_app("pagerank")
    s = app.init(0)
    for _ in range(n_iters):
        s = app.run_iteration(s)
    return s


@pytest.mark.parametrize("n", [0, 4, 15])
def test_spmv_within_rtol_of_jax(n):
    s = _state(n)
    want = np.asarray(jpr._spmv(jnp.asarray(s["links"]), jnp.asarray(s["rank"])))
    got = tpr._spmv(torch.tensor(s["links"]), torch.tensor(s["rank"])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n", [0, 4, 15])
def test_damped_bitwise_equal_jax(n):
    s = jax_ci_app("pagerank")._region_spmv(_state(n))
    want, want_delta = jpr._damped(jnp.asarray(s["y"]), jnp.asarray(s["rank"]), 0.9)
    got, delta = tpr._damped(torch.tensor(s["y"]), torch.tensor(s["rank"]), 0.9)
    assert _bits(got) == _bits(want)
    assert abs(float(delta) - float(want_delta)) <= RTOL * float(want_delta)


@pytest.mark.parametrize("n", [0, 4, 15])
def test_residual_within_tolerance_of_jax(n):
    """The fixed-point residual is a sum of |G(rank) - rank|: the spmv's
    difference enters it at most scaled by the rank's mass (1)."""
    s = _state(n)
    want = jax_ci_app("pagerank").progress(s)
    got = ci_app("pagerank", device="cpu").progress(s)
    assert abs(got - want) <= RTOL * float(np.abs(s["rank"]).sum())


def test_lane_spmv_does_not_depend_on_the_stack():
    app = ci_app("pagerank", device="cpu")
    s = _state(3)
    links = torch.tensor(s["links"])
    rng = np.random.default_rng(0)
    ranks = torch.tensor((s["rank"] * (1 + 1e-3 * rng.standard_normal((5, 192))))
                             .astype(np.float32))
    stacked = app._spmv_batch(links, ranks)
    for i in range(5):
        assert _bits(stacked[i]) == _bits(tpr._spmv(links, ranks[i].clone()))
