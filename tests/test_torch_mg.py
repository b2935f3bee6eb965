"""The port's mg grid functions and V-cycle against the JAX package's, on
the CPU, bit for bit.

``jacobi_sweep`` rounds its update once (XLA's fused multiply-add, as
``torch.addcmul``), ``restrict`` adds each 2 x 2 cell in the order of XLA's
CPU reduce (row pairs first where the grid is a power of two, else one by
one), ``prolong`` only copies; one V-cycle of the
port's serial regions, and its batched core per lane, equal JAX's serial
regions.  Inputs span many binades, so an order or a rounding that differs
shows in most cells.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import common as jcommon
from repro.hpc.suite import ci_app as jax_ci_app
from repro_torch.hpc import common as tcommon
from repro_torch.hpc import mg as tmg
from repro_torch.hpc.suite import ci_app

#: powers of two (the CI grid 32) and not (the bench grid 48)
GRIDS = [8, 16, 32, 34, 48, 66]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _field(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp(rng.uniform(-6, 6, n))).astype(np.float32)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("g", GRIDS)
def test_jacobi_sweep_bitwise(g):
    u, b = _field(g * g, 1), _field(g * g, 2)
    want = jcommon.jacobi_sweep(jnp.asarray(u), jnp.asarray(b), g)
    assert _bits(tcommon.jacobi_sweep(torch.from_numpy(u), torch.from_numpy(b), g)) == _bits(want)
    # lanes: a stack of three, b broadcast from one lane
    stack = np.stack([u, _field(g * g, 3), u * 2])
    got = tcommon.jacobi_sweep(torch.from_numpy(stack), torch.from_numpy(b), g)
    for i in range(3):
        assert _bits(got[i]) == _bits(jcommon.jacobi_sweep(jnp.asarray(stack[i]),
                                                           jnp.asarray(b), g))


@pytest.mark.parametrize("g", GRIDS)
def test_restrict_bitwise(g):
    r = _field(g * g, 4)
    want = jcommon.restrict(jnp.asarray(r), g)
    assert _bits(tcommon.restrict(torch.from_numpy(r), g)) == _bits(want)
    stack = np.stack([r, _field(g * g, 5)])
    got = tcommon.restrict(torch.from_numpy(stack), g)
    assert got.shape == (2, (g // 2) ** 2)
    assert _bits(got[1]) == _bits(jcommon.restrict(jnp.asarray(stack[1]), g))


@pytest.mark.parametrize("g", GRIDS)
def test_prolong_bitwise(g):
    e = _field((g // 2) ** 2, 6)
    want = jcommon.prolong(jnp.asarray(e), g)
    assert _bits(tcommon.prolong(torch.from_numpy(e), g)) == _bits(want)
    stack = np.stack([e, -e])
    assert _bits(tcommon.prolong(torch.from_numpy(stack), g)[1]) == _bits(
        jcommon.prolong(jnp.asarray(-e), g))


@pytest.mark.parametrize("n_cycles,grid", [(1, 32), (5, 32), (3, 48)])
def test_v_cycle_bitwise_equal_jax(n_cycles, grid):
    """The port's serial regions and its batched core against JAX's serial
    regions, from a perturbed start, at the CI and the bench grid."""
    japp, tapp = jax_ci_app("mg", grid=grid), ci_app("mg", grid=grid, device="cpu")
    s = japp.init(0)
    s["u"] = _field(s["u"].size, 7) * np.float32(1e-3)
    js, ts = dict(s), {k: np.array(v, copy=True) for k, v in s.items()}
    for _ in range(n_cycles):
        js, ts = japp.run_iteration(js), tapp.run_iteration(ts)
    for k in js:
        assert _bits(ts[k]) == _bits(js[k]), k
    core = tmg._cycle_core({f: torch.from_numpy(np.stack([s[f]])) for f in tapp._CARRY},
                           torch.from_numpy(s["b"].copy()), tapp.grid, tapp.coarse_sweeps,
                           tapp.fine_sweeps)
    one = japp.run_iteration(dict(s))
    for f in tapp._CARRY:
        assert _bits(core[f][0]) == _bits(one[f]), f


def test_golden_run_bitwise_equal_jax():
    """The CI golden run, 24 V-cycles, is JAX's state for state and its
    final relative residual JAX's."""
    japp, tapp = jax_ci_app("mg"), ci_app("mg", device="cpu")
    js, ts = japp.init(0), tapp.init(0)
    for it in range(japp.n_iters):
        js, ts = japp.run_iteration(js), tapp.run_iteration(ts)
        for k in js:
            assert _bits(ts[k]) == _bits(js[k]), (it, k)
    assert tapp._golden_residual() == japp._golden_residual()
