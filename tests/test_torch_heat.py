"""The port's heat steps against the JAX package's, on the CPU, bit for bit.

XLA contracts the explicit step ``u + dt * lap`` into one fused
multiply-add; the port writes it as ``torch.addcmul(u, lap, dt)``, which
rounds once the same way, and the tests demand exact equality (a separate
multiply and add differs after one step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import heat as jheat
from repro_torch.hpc import heat as theat


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


def _inputs(g, lanes=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (g * g,) if lanes is None else (lanes, g * g)
    u = rng.random(shape).astype(np.float32)
    pins = jheat.HeatApp(grid=g).init(0)["pins"]
    mask = np.zeros(g * g, bool)
    mask[pins] = True
    return u, pins, mask


@pytest.mark.parametrize("g", [32, 33])
def test_laplace_bitwise(g):
    u, _, _ = _inputs(g)
    assert _bits(theat._laplace(torch.tensor(u), g)) == _bits(jheat._laplace(jnp.asarray(u), g))


@pytest.mark.parametrize("steps", [1, 8, 80])
@pytest.mark.parametrize("g", [32, 33])
def test_diffuse_bitwise(g, steps):
    u, pins, mask = _inputs(g)
    want = jheat._diffuse(jnp.asarray(u), jnp.asarray(pins), g, steps, 0.2)
    got = theat._diffuse(torch.tensor(u), torch.tensor(mask), g, steps, 0.2)
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("g", [32, 33])
def test_batched_step_bitwise_equal_jax(g):
    """The port's batched iteration against JAX's _heat_step_batch: flux and
    u of every lane, bit for bit."""
    u, pins, mask = _inputs(g, lanes=4, seed=1)
    jflux, ju = jheat._heat_step_batch(jnp.asarray(u), jnp.asarray(mask), g, 8, 0.2)
    app = theat.HeatApp(grid=g, device="cpu")
    states = []
    for i in range(4):
        s = app.init(0)
        s["u"] = u[i]
        states.append(s)
    out = app.run_iteration_batch(states)
    for i, s in enumerate(out):
        assert _bits(s["flux"]) == _bits(np.asarray(jflux)[i])
        assert _bits(s["u"]) == _bits(np.asarray(ju)[i])


def test_serial_iteration_and_residual_bitwise_equal_jax():
    japp, tapp = jheat.HeatApp(grid=32), theat.HeatApp(grid=32, device="cpu")
    s = japp.init(0)
    for _ in range(5):
        js, ts = japp.run_iteration(s), tapp.run_iteration(s)
        for k in js:
            assert _bits(ts[k]) == _bits(js[k]), k
        assert tapp.progress(ts) == japp.progress(js)
        assert tapp.verify(ts).spec() == japp.verify(js).spec()
        s = js
