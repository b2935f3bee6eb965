"""The port's RG-LRU scan against the JAX package's, on the CPU.

On a CPU tensor the port's op runs its plain version, a sequential scan (the
CUDA kernel is checked against it on the card: tests/test_torch_cuda.py,
chip_smoke.py).  The JAX oracle is an associative_scan and the JAX op's
interpret mode a sequential one; both multiply and add in f32, in other
orders than each other, so the port is held to 1e-5 (abs and rel) against
both, as tests/test_kernels.py holds the JAX op to its oracle, and to 1e-4
in the property grid, as there.  Inputs are made by numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_reference as jax_rglru_reference
from repro.models import init_params as jax_init_params
from repro.models import rglru as jax_rglru
from repro.models import scaled_down as jax_scaled_down
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_reference
from repro_torch.models import rglru, scaled_down

TOL, PROPERTY_TOL, F32_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(b, t, d, seed, scale=0.98):
    """a in (0, scale) (a sigmoid of a normal), x normal; float32."""
    rng = np.random.default_rng(seed)
    a = (scale / (1 + np.exp(-rng.standard_normal((b, t, d))))).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("b,t,d,bt,bd", [(2, 64, 128, 32, 128), (1, 128, 256, 64, 128),
                                         (3, 32, 64, 32, 64)])
def test_plain_version_matches_jax_op_and_oracle(b, t, d, bt, bd):
    a, x = _inputs(b, t, d, seed=4)
    want_op = np.asarray(jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), block_t=bt, block_d=bd))
    want_ref = np.asarray(jax_rglru_reference(jnp.asarray(a), jnp.asarray(x)))
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(x), block_t=bt, block_d=bd)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, d)
    np.testing.assert_allclose(got.numpy(), want_op, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t_pow,d_mult,seed", [(4, 1, 0), (5, 2, 11), (6, 3, 97), (7, 1, 500),
                                               (7, 3, 1000)])
def test_plain_version_property_grid(t_pow, d_mult, seed):
    """test_kernels.py's property test at fixed points: a a full sigmoid
    (up to 1), T up to 128, D up to 192."""
    t, d = 2 ** t_pow, 64 * d_mult
    a, x = _inputs(1, t, d, seed=seed, scale=1.0)
    want = np.asarray(jax_rglru_reference(jnp.asarray(a), jnp.asarray(x)))
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(x), block_t=min(64, t), block_d=64)
    np.testing.assert_allclose(got.numpy(), want, atol=PROPERTY_TOL, rtol=PROPERTY_TOL)


def test_bf16_inputs_upcast_exactly():
    """bfloat16 gates and inputs give the float32 scan of the same values."""
    a, x = _inputs(2, 32, 64, seed=5)
    ta, tx = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    got = rglru_scan(ta, tx)
    assert torch.equal(got, rglru_reference(ta.float(), tx.float()))
    want = jax_rglru_reference(jnp.asarray(a, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_rounds_product_and_add_one_at_a_time():
    """The plain version's step is two rounded f32 ops, as the kernel's
    (__fmul_rn, __fadd_rn): equal to a float64-free step-by-step numpy run."""
    a, x = _inputs(2, 16, 64, seed=6)
    h = np.zeros((2, 64), np.float32)
    want = np.empty_like(a)
    for t in range(16):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        want[:, t] = h
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_independence_and_contract():
    a, x = (torch.from_numpy(v) for v in _inputs(2, 96, 192, seed=7))
    assert torch.equal(rglru_scan(a, x, block_t=32, block_d=64),
                       rglru_scan(a, x, block_t=96, block_d=192))
    with pytest.raises(ValueError, match="multiple"):
        rglru_scan(a, x, block_t=64)          # 96 % 64
    with pytest.raises(ValueError, match="multiple"):
        rglru_scan(a, x, block_d=128)         # 192 % 128
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, x[:, :32])
    with pytest.raises(ValueError, match="cuda or cpu"):
        rglru_scan(a.to("meta"), x.to("meta"), block_t=32, block_d=64)


# ------------------------------------------------------------ the layer
def _layer(dtype):
    jcfg = dataclasses.replace(jax_scaled_down(jax_get_arch("recurrentgemma-9b"), width=64),
                               dtype=dtype)
    tcfg = dataclasses.replace(scaled_down(get_arch("recurrentgemma-9b"), width=64), dtype=dtype)
    jp = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax_init_params(jcfg, jax.random.PRNGKey(2))["group0"]["pos0"]["rec"])
    return jcfg, tcfg, jp, params_from_jax(jp, "cpu")


def _x(dtype, b=2, s=32, seed=9):
    x = np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_rglru_full_f32_matches_jax(impl):
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32")
    got = rglru.rglru_full(tp, tx, tcfg, impl=impl)
    for jimpl in ("reference", "pallas"):
        want = jax_rglru.rglru_full(jp, jx, jcfg, impl=jimpl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_rglru_full_state_matches_jax_state_after(impl):
    """return_state leaves the output as it was.  h is JAX's prefill
    recompute (_rec_state_after, an associative_scan) to 1e-4; conv is the
    pre-conv projection's tail, equal to JAX's."""
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32")
    out, state = rglru.rglru_full(tp, tx, tcfg, impl=impl, return_state=True)
    assert torch.equal(out, rglru.rglru_full(tp, tx, tcfg, impl=impl))
    want = jax_transformer._rec_state_after(jcfg, jp, jx)
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(want["h"]), atol=F32_TOL,
                               rtol=F32_TOL)
    cw = tcfg.rec.conv_width
    assert torch.equal(state["conv"], (tx @ tp["w_in_x"])[:, -(cw - 1):])
    np.testing.assert_array_equal(state["conv"].numpy(), np.asarray(want["conv"]))


def test_rglru_full_bf16_matches_jax():
    """bfloat16: XLA's f32 exp and logistic differ from torch's in the last
    bit now and then, and a flipped rounding of h to bf16 in any of the 64
    channels moves the output projection: held to 5e-2 (abs and rel)."""
    jcfg, tcfg, jp, tp = _layer("bfloat16")
    jx, tx = _x("bfloat16")
    want = np.asarray(jax.jit(lambda p, x: jax_rglru.rglru_full(p, x, jcfg))(jp, jx))
    got = rglru.rglru_full(tp, tx, tcfg, impl="kernel")
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=5e-2, rtol=5e-2)


def test_conv_and_gates_match_jax():
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32", s=8)
    rng = np.random.default_rng(10)
    prefix = rng.standard_normal((2, 3, 64)).astype(np.float32)
    want = jax_rglru._causal_conv(jx, jp["conv"], jnp.asarray(prefix))
    got = rglru._causal_conv(tx, tp["conv"], torch.from_numpy(prefix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    ja, jg = jax_rglru._gates(jp, jx)
    ta, tg = rglru._gates(tp, tx)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)


def test_rglru_decode_steps_match_jax():
    """12 decode steps from a random state, in float32, to 1e-4."""
    jcfg, tcfg, jp, tp = _layer("float32")
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jh, jc = jnp.asarray(h), jnp.asarray(conv)
    th, tc = torch.from_numpy(h), torch.from_numpy(conv)
    for _ in range(12):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jh, jc = jax_rglru.rglru_decode_step(jp, jnp.asarray(x), jh, jc, jcfg)
        ty, th, tc = rglru.rglru_decode_step(tp, torch.from_numpy(x), th, tc, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=F32_TOL, rtol=F32_TOL)
