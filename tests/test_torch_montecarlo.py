"""The port's threefry stream and montecarlo app against JAX, on the CPU.

``repro_torch.hpc.threefry`` reproduces ``jax.random``'s keys, bits and
uniforms bit for bit (jax_threefry_partitionable on, jax 0.9.0's default);
its normals agree with JAX's to within 4 ulp, and bitwise for all but a few
elements in 10,000 (XLA's own logf differs in the last bit there).  The
per-round tallies equal ``_tally_batch``'s exactly at the JAX package's
tiny, CI and bench sizes, and the golden counts equal the JAX app's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hpc import montecarlo as jmc
from repro_torch.hpc import montecarlo as tmc
from repro_torch.hpc import threefry

#: (seed, data) pairs for fold_in, the data up to the full 32 bits
KEYS = [(1234, 0), (1234, 3), (0, 7), (42, 2**31 + 5), (2**32 - 1, 2**32 - 1)]
#: shapes with odd lengths and odd sizes
SHAPES = [(1,), (7,), (33, 3), (1024, 2), (5, 3, 11)]
#: the most ulp a normal may differ from JAX's, and the most elements in
#: 10,000 that may differ at all
NORMAL_ULP, NORMAL_PER_10K = 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_key(seed, data):
    return jax.random.fold_in(jax.random.PRNGKey(seed), data)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed,data", KEYS)
def test_fold_in_and_bits_equal_jax(seed, data):
    key = threefry.fold_in(threefry.prng_key(seed), data)
    jkey = _jax_key(seed, data)
    assert key == tuple(int(v) for v in jax.random.key_data(jkey))
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64).reshape(-1)
        got = threefry.random_bits(key, int(np.prod(shape))).numpy()
        assert np.array_equal(got, want), shape


@pytest.mark.parametrize("seed,data", KEYS)
def test_uniform_equals_jax(seed, data):
    key, jkey = threefry.fold_in(threefry.prng_key(seed), data), _jax_key(seed, data)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    for shape in SHAPES:
        for a, b in ((0.0, 1.0), (lo, 1.0)):
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, a, b))
            got = threefry.uniform(key, shape, a, b).numpy()
            assert got.shape == want.shape and got.tobytes() == want.tobytes(), (shape, a)


def test_draw_in_pieces_equals_one_draw():
    key = threefry.fold_in(threefry.prng_key(1234), 9)
    whole = threefry.normal(key, (1000, 2))
    parts = torch.cat([threefry.normal(key, (n, 2), offset=2 * lo)
                       for lo, n in ((0, 300), (300, 1), (301, 699))])
    assert torch.equal(whole.view(torch.int32), parts.view(torch.int32))


@pytest.mark.parametrize("data", range(6))
def test_normal_within_ulps_of_jax(data):
    key, jkey = threefry.fold_in(threefry.prng_key(1234), data), _jax_key(1234, data)
    want = np.asarray(jax.random.normal(jkey, (8192, 2))).reshape(-1)
    got = threefry.normal(key, (8192, 2)).numpy().reshape(-1)
    ulp = _ulp(got, want)
    assert ulp.max() <= NORMAL_ULP
    assert (ulp > 0).sum() <= NORMAL_PER_10K * want.size / 10_000


def test_log1p_and_erfinv_equal_xla_where_they_should():
    """log1p's rational branch and erfinv's polynomial (given JAX's log1p)
    are XLA's bit for bit; the logf branch misses by one ulp at most."""
    key = threefry.fold_in(threefry.prng_key(1234), 3)
    u = threefry.uniform(key, (20480,), float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)
    x = -u * u
    want = np.asarray(jax.jit(jnp.log1p)(x.numpy()))
    got = threefry.log1p_xla(x).numpy()
    small = np.abs(x.numpy()) < 0.41421356237309504880
    assert np.array_equal(got[small], want[small])
    assert _ulp(got[~small], want[~small]).max() <= 1
    want_e = np.asarray(jax.jit(jax.lax.erf_inv)(u.numpy()))
    got_e = threefry.erfinv_xla(u).numpy()
    same_w = got == want
    assert np.array_equal(got_e[same_w], want_e[same_w])


@pytest.mark.parametrize("batch,rounds", [(256, 8), (1024, 10), (8192, 24)])
def test_tallies_equal_jax(batch, rounds):
    """Per round, the tally equals _tally_batch's exactly (tiny, CI and
    bench sizes of the JAX package)."""
    for k in range(rounds):
        want = np.asarray(jmc._tally_batch(jnp.asarray(k), batch, 10)).astype(np.int64)
        got, scratch = tmc._round(k, batch, 10, "cpu")
        assert np.array_equal(got.numpy(), want), k
        assert scratch.shape == (batch,) and scratch.dtype == torch.float32


def test_tally_rounding_is_jits_and_scratch_rounding_eagers():
    """x*x + y*y rounds as fma(y, y, x*x) in jit (the tally path) and as
    two rounded products and a sum eagerly (the scratch path): bitwise on
    the same pairs."""
    xy = jax.random.normal(_jax_key(1234, 3), (4096, 2))
    jit_rad2 = np.asarray(jax.jit(lambda v: jnp.sum(v * v, axis=-1))(xy))
    eager_rad2 = np.asarray(jnp.sum(xy * xy, axis=-1))
    t = torch.from_numpy(np.array(xy))
    x, y = t[:, 0], t[:, 1]
    assert torch.addcmul(x * x, y, y).numpy().tobytes() == jit_rad2.tobytes()
    assert (x * x + y * y).numpy().tobytes() == eager_rad2.tobytes()


@pytest.mark.parametrize("batch,n_iters", [(256, 8), (1024, 10)])
def test_golden_counts_equal_jax(batch, n_iters):
    japp = jmc.MonteCarloApp(batch=batch, n_iters=n_iters)
    tapp = tmc.MonteCarloApp(batch=batch, n_iters=n_iters, device="cpu")
    assert np.array_equal(tapp._golden(), japp._golden())
    js, ts = japp.init(0), tapp.init(0)
    for _ in range(3):
        js, ts = japp.run_iteration(js), tapp.run_iteration(ts)
    assert np.array_equal(ts["counts"], js["counts"])
    assert ts["sums"][0] == js["sums"][0]
    # the scratch sums differ in order only (tree_sum against np.sum)
    np.testing.assert_allclose(ts["sums"][1], js["sums"][1], rtol=1e-5)
    assert ts["k"].tobytes() == js["k"].tobytes()
