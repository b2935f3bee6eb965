"""The port's CG against the JAX package's, on the CPU.

The matvec and the axpy updates are bitwise JAX's given the same scalars
(separately rounded multiply and add, as NumPy does them in the JAX
regions).  The dots are not: JAX sums in XLA's order, the port in
``tree_sum``'s fixed order, so they agree to a relative 1e-6 (the app's
dots are sums of positive terms, p.Ap and r.r).  Within the port the fixed
order makes a lane of a stack sum exactly as the same vector alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import cg as jcg
from repro.hpc.suite import ci_app as jax_ci_app
from repro_torch.hpc import cg as tcg
from repro_torch.hpc.common import laplacian_apply, tree_sum
from repro_torch.hpc.suite import ci_app

DOT_RTOL = 1e-6


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


def _trajectory(n):
    """The JAX app's state after ``n`` iterations."""
    app = jax_ci_app("cg")
    s = app.init(0)
    for _ in range(n):
        s = app.run_iteration(s)
    return s


@pytest.mark.parametrize("n", [0, 7, 30])
def test_dots_within_rtol_of_jax(n):
    s = _trajectory(n)
    q = np.asarray(jcg.laplacian_apply(jnp.asarray(s["p"]), 24))
    for a, b in ((s["p"], q), (s["r"], s["r"])):
        want = float(jcg._dot(jnp.asarray(a), jnp.asarray(b)))
        got = float(tcg._dot(torch.tensor(a), torch.tensor(b)))
        exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
        assert abs(got - want) <= DOT_RTOL * abs(want)
        assert abs(got - exact) <= DOT_RTOL * abs(exact)


@pytest.mark.parametrize("n", [1, 2, 576, 1000, 1025])
def test_tree_sum_lane_equals_alone(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    stacked = tree_sum(x)
    for i in range(3):
        alone = tree_sum(x[i].clone())
        assert _bits(stacked[i]) == _bits(alone)
        assert abs(float(alone) - float(x[i].double().sum())) <= 1e-5 * float(x[i].abs().sum())


@pytest.mark.parametrize("n", [0, 7, 19])
def test_regions_bitwise_equal_jax_given_the_same_scalars(n):
    """Each region of the port on JAX's state: the vectors are JAX's bits
    where the region's scalars come from its input state (matvec, r and p
    updates, including the residual replacement at k 19); the x update's
    x is the numpy axpy of the port's alpha, which is within 1e-6 of JAX's."""
    japp, tapp = jax_ci_app("cg"), ci_app("cg", device="cpu")
    s = japp._matvec(_trajectory(n))
    assert _bits(tapp._matvec(s)["q"]) == _bits(s["q"])
    jx, tx = japp._x_update(s), tapp._x_update(s)
    assert abs(float(tx["alpha"][0]) - float(jx["alpha"][0])) <= DOT_RTOL * abs(float(jx["alpha"][0]))
    assert _bits(tx["x"]) == _bits(s["x"] + tx["alpha"][0] * s["p"])
    jr, tr = japp._r_update(jx), tapp._r_update(jx)
    assert _bits(tr["r"]) == _bits(jr["r"])
    assert _bits(tr["rho_prev"]) == _bits(jr["rho_prev"])
    assert abs(float(tr["rho"][0]) - float(jr["rho"][0])) <= DOT_RTOL * float(jr["rho"][0])
    jp, tp = japp._p_update(jr), tapp._p_update(jr)
    for k in ("p", "k"):
        assert _bits(tp[k]) == _bits(jp[k]), k


def test_init_and_residual_equal_jax():
    japp, tapp = jax_ci_app("cg"), ci_app("cg", device="cpu")
    js, ts = japp.init(0), tapp.init(0)
    for k in js:
        assert _bits(ts[k]) == _bits(js[k]), k
    s = _trajectory(12)
    assert tapp.progress(s) == japp.progress(s)
    assert tapp.converged(s, 12) == japp.converged(s, 12)
    assert _bits(laplacian_apply(torch.from_numpy(s["x"]), 24)) == _bits(
        jcg.laplacian_apply(jnp.asarray(s["x"]), 24))
