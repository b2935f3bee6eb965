"""The port's dirty-block mask against the JAX package's ``delta_snapshot``.

The JAX op runs its Pallas kernel in interpret mode on the CPU, as the JAX
package's own kernel tests run it; the port's op takes its plain PyTorch
version for CPU tensors.  Masks must be equal exactly.  The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "jax.experimental.pallas", reason="kernel tests need a Pallas-capable jax build"
)

from repro.kernels.delta_snapshot.ops import dirty_block_mask as jax_dirty_block_mask
from repro_torch.core.blocks import block_diff_mask
from repro_torch.core.delta_persist import delta_block_mask
from repro_torch.kernels.delta_snapshot import dirty_block_mask


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(n, dtype, seed):
    """x and a copy with a few elements changed, as the JAX package's
    differential test makes them."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, size=n).astype(np.int32)
    else:
        x = rng.standard_normal(n).astype(np.float32)
    p = x.copy()
    p[rng.choice(n, size=min(5, n), replace=False)] += 1
    return x, p


def _both(a, dtype):
    """The same values as a jax array and a torch tensor, bit for bit."""
    if dtype == "bfloat16":
        ja = jnp.asarray(a, jnp.bfloat16)
        bits = np.asarray(ja).view(np.int16)
        return ja, torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000, 4097])
def test_plain_version_equals_jax_op(n, dtype):
    """At the sizes and dtypes of the JAX differential test: the port's mask
    equals the JAX op's exactly, and identical inputs are all clean."""
    x, p = _pair(n, dtype, n)
    xj, xt = _both(x, dtype)
    pj, pt = _both(p, dtype)
    want = np.asarray(jax_dirty_block_mask(xj, pj, block_elems=256))
    got = dirty_block_mask(xt, pt, block_elems=256)
    assert got.dtype == torch.int32 and got.shape == (-(-n // 256),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not dirty_block_mask(xt, xt.clone(), block_elems=256).any()


@pytest.mark.parametrize("n,block_bytes", [(300, 64), (1024, 64), (65, 32)])
def test_byte_view_mask_equals_jax_op_and_block_diff(n, block_bytes):
    """The flush path's mask (uint8 views, block_elems = block_bytes) equals
    the JAX op over the same bytes and the host block_diff_mask."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n).astype(np.float32)
    p = x.copy()
    p[rng.choice(n, size=4, replace=False)] *= -1.0
    want = np.asarray(jax_dirty_block_mask(
        jnp.asarray(p.view(np.uint8)), jnp.asarray(x.view(np.uint8)), block_elems=block_bytes,
    )).astype(bool)
    got = delta_block_mask(x, p, block_bytes)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, block_diff_mask(x, p, block_bytes))
    np.testing.assert_array_equal(
        delta_block_mask(torch.from_numpy(x), torch.from_numpy(p), block_bytes).numpy(), want
    )


def test_float_compare_semantics_equal_jax():
    """NaN != NaN and -0.0 == +0.0 in float32, as in the JAX op."""
    x = np.zeros(1024, np.float32)
    p = x.copy()
    x[3] = np.nan            # block 0: NaN vs 0 -> dirty
    x[300] = p[300] = np.nan  # block 1: NaN vs NaN -> dirty
    x[600] = -0.0            # block 2: -0 vs +0 -> clean
    want = np.asarray(jax_dirty_block_mask(jnp.asarray(x), jnp.asarray(p), block_elems=256))
    got = dirty_block_mask(torch.from_numpy(x), torch.from_numpy(p), block_elems=256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 1, 0, 0])


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097])
def test_delta_block_mask_equals_block_diff_mask(n):
    """Sparse random dirt in uint8 leaves, numpy and tensor inputs."""
    rng = np.random.default_rng(n + 1)
    x = rng.integers(0, 256, size=n).astype(np.uint8)
    p = x.copy()
    if n:
        idx = rng.choice(n, size=max(1, n // 50), replace=False)
        p[idx] ^= 0x5A
    want = block_diff_mask(x, p, 64)
    np.testing.assert_array_equal(delta_block_mask(x, p, 64), want)
    got = delta_block_mask(torch.from_numpy(x), torch.from_numpy(p), 64)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_it_does_not_take():
    a = torch.zeros(8)
    with pytest.raises(TypeError):
        dirty_block_mask(a.numpy(), a.numpy())
    with pytest.raises(ValueError):
        dirty_block_mask(a, torch.zeros(9))
    with pytest.raises(ValueError):
        dirty_block_mask(a, a.to(torch.float64))
    with pytest.raises(ValueError):
        dirty_block_mask(a, a, block_elems=0)
    with pytest.raises(ValueError):  # neither cuda nor cpu: no quiet fallback
        dirty_block_mask(a.to("meta"), a.to("meta"))


def test_launch_counter_untouched_on_cpu():
    before = dirty_block_mask.launches
    dirty_block_mask(torch.zeros(300), torch.ones(300))
    assert dirty_block_mask.launches == before
