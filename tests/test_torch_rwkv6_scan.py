"""The port's RWKV-6 scan against the JAX package's, on the CPU.

On a CPU tensor the port's op runs its plain version (the CUDA kernel is
checked against it on the card: tests/test_torch_cuda.py, chip_smoke.py).
Inputs are made by numpy from a seed and handed to both packages.
Tolerances are tests/test_kernels.py's: 1e-4 (abs and rel) for float32
inputs, 5e-2 for bfloat16 inputs (both sides upcast them to f32 and sum in
other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_reference as jax_rwkv6_reference
from repro.models import init_params as jax_init_params
from repro.models import rwkv6 as jax_rwkv6
from repro.models import scaled_down as jax_scaled_down
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference
from repro_torch.models import rwkv6, scaled_down

F32_TOL, BF16_TOL = 1e-4, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(b, t, h, d, seed):
    """r, k, v, w (B, T, H, D) and u (H, D) in float32, as test_kernels.py
    draws them: normals times 0.5, w a sigmoid of a normal, u normal * 0.3."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, t, h, d))))).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.3
    return r, k, v, w, u


def _to(xs, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(x, jdt) for x in xs], [torch.from_numpy(x).to(tdt) for x in xs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,d,bt", [(2, 3, 64, 16, 32), (1, 2, 128, 64, 64),
                                        (1, 1, 96, 32, 32)])
def test_plain_version_matches_jax_op_and_oracle(b, h, t, d, bt, dtype):
    r, k, v, w, u = _inputs(b, t, h, d, seed=2)
    (jr, jk, jv, jw), (tr, tk, tv, tw) = _to((r, k, v, w), dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want_op = np.asarray(jax_rwkv6_scan(jr, jk, jv, jw, jnp.asarray(u), block_t=bt))
    want_ref = np.asarray(jnp.swapaxes(jax_rwkv6_reference(
        *(jnp.swapaxes(x, 1, 2) for x in (jr, jk, jv, jw)), jnp.asarray(u)), 1, 2))
    got = rwkv6_scan(tr, tk, tv, tw, torch.from_numpy(u), block_t=bt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, h, d)
    np.testing.assert_allclose(got.numpy(), want_op, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=tol, rtol=tol)
    # the plain version in the oracle's own (B, H, T, D) layout
    got_bhtd = rwkv6_reference(*(x.transpose(1, 2) for x in (tr, tk, tv, tw)),
                               torch.from_numpy(u))
    np.testing.assert_allclose(got_bhtd.transpose(1, 2).numpy(), want_ref, atol=tol, rtol=tol)


def test_chunking_independence():
    """test_kernels.py's case: block_t 32 and 128 give the same result (the
    JAX op to 1e-4; the port's exactly, block_t sets no arithmetic)."""
    r, k, v, w, u = _inputs(1, 128, 2, 32, seed=3)
    tr, tk, tv, tw, tu = (torch.from_numpy(x) for x in (r, k, v, w, u))
    a = rwkv6_scan(tr, tk, tv, tw, tu, block_t=32)
    b = rwkv6_scan(tr, tk, tv, tw, tu, block_t=128)
    assert torch.equal(a, b)
    want = jax_rwkv6_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)), block_t=32)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_op_keeps_the_jax_contract():
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(1, 96, 2, 16, seed=4))
    with pytest.raises(ValueError, match="multiple"):
        rwkv6_scan(r, k, v, w, u, block_t=64)  # 96 % 64
    assert rwkv6_scan(r, k, v, w, u, block_t=32).shape == r.shape
    with pytest.raises(ValueError, match="shape"):
        rwkv6_scan(r, k[:, :48], v, w, u)
    with pytest.raises(ValueError, match=r"\(H, D\)"):
        rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        rwkv6_scan(*(x.to("meta") for x in (r, k, v, w, u)))


def test_op_returns_the_final_state():
    """return_state: y unchanged, S (B, H, D, D) the plain loop's final state,
    held to JAX's oracle run one token further (its last y is r . S_T with
    r = e_i picking row i of S_T)."""
    r, k, v, w, u = _inputs(2, 48, 3, 16, seed=5)
    tr, tk, tv, tw, tu = (torch.from_numpy(x) for x in (r, k, v, w, u))
    y, S = rwkv6_scan(tr, tk, tv, tw, tu, block_t=16, return_state=True)
    assert torch.equal(y, rwkv6_scan(tr, tk, tv, tw, tu, block_t=16))
    assert S.dtype == torch.float32 and tuple(S.shape) == (2, 3, 16, 16)
    for i in (0, 7, 15):
        # one more token with k = 0 (no update, no bonus) and r = e_i
        ext = [np.concatenate([x, np.zeros_like(x[:, :1])], axis=1) for x in (r, k, v, w)]
        ext[0][:, -1, :, i] = 1.0
        want = jax_rwkv6_reference(*(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in ext),
                                   jnp.asarray(u))
        np.testing.assert_allclose(S[:, :, i, :].numpy(), np.asarray(want)[:, :, -1],
                                   atol=F32_TOL, rtol=F32_TOL)


def test_plain_version_final_state_equals_the_token_loop():
    """The plain version's final S equals, bit for bit, the token loop the
    port's prefill used to run after the scan (S <- w S + k^T v)."""
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(2, 40, 3, 32, seed=6))
    _, S = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u, return_state=True)
    want = torch.zeros_like(S)
    for t in range(r.shape[1]):
        want = w[:, t][..., :, None] * want + k[:, t][..., :, None] * v[:, t][..., None, :]
    assert torch.equal(S, want)


# ------------------------------------------------------------ the layer
def _layer(dtype):
    jcfg = dataclasses.replace(jax_scaled_down(jax_get_arch("rwkv6-3b"), width=64), dtype=dtype)
    tcfg = dataclasses.replace(scaled_down(get_arch("rwkv6-3b"), width=64), dtype=dtype)
    jp = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax_init_params(jcfg, jax.random.PRNGKey(1))["group0"]["pos0"]["rwkv"])
    # random token-shift lerps (the init's are zeros) so x_prev is used
    rng = np.random.default_rng(6)
    jp["mix_lerp"] = np.asarray(jnp.asarray(rng.uniform(0, 1, jp["mix_lerp"].shape),
                                            jp["mix_lerp"].dtype))
    return jcfg, tcfg, jp, params_from_jax(jp, "cpu")


def _x(dtype, b=2, s=32, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_rwkv_scan_full_f32_matches_jax(impl):
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32")
    want = jax_rwkv6.rwkv_scan_full(jp, jx, jcfg)
    got = rwkv6.rwkv_scan_full(tp, tx, tcfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    want_pallas = jax_rwkv6.rwkv_scan_full(jp, jx, jcfg, impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_rwkv_scan_full_state_matches_jax_state_after(impl):
    """return_state leaves the output as it was; the state is JAX's
    prefill recompute (_rwkv_state_after) to 1e-4, x_last the input's last
    token."""
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32")
    out, state = rwkv6.rwkv_scan_full(tp, tx, tcfg, impl=impl, return_state=True)
    assert torch.equal(out, rwkv6.rwkv_scan_full(tp, tx, tcfg, impl=impl))
    want = jax_transformer._rwkv_state_after(jcfg, jp, jx)
    np.testing.assert_allclose(state["S"].numpy(), np.asarray(want["S"]), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_array_equal(state["x_last"].numpy(), np.asarray(want["x_last"]))


def test_rwkv_scan_full_bf16_matches_jax():
    """bfloat16: the layer's output agrees with JAX's to one bf16 step of its
    largest values (5e-2), and nearly all of it bit for bit."""
    jcfg, tcfg, jp, tp = _layer("bfloat16")
    jx, tx = _x("bfloat16")
    want = np.asarray(jax.jit(lambda p, x: jax_rwkv6.rwkv_scan_full(p, x, jcfg))(jp, jx))
    got = rwkv6.rwkv_scan_full(tp, tx, tcfg, impl="kernel")
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    assert np.mean(got.view(torch.int16).numpy() == want.view(np.int16)) > 0.9


def test_rwkv_decode_steps_match_jax():
    """12 decode steps from a random state, in float32, to 1e-4."""
    jcfg, tcfg, jp, tp = _layer("float32")
    rng = np.random.default_rng(8)
    H, dh = 4, 16
    S = rng.standard_normal((2, H, dh, dh)).astype(np.float32) * 0.1
    x_last = rng.standard_normal((2, 64)).astype(np.float32)
    jS, jxl = jnp.asarray(S), jnp.asarray(x_last)
    tS, txl = torch.from_numpy(S), torch.from_numpy(x_last)
    for step in range(12):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jS, jxl = jax_rwkv6.rwkv_decode_step(jp, jnp.asarray(x), jS, jxl, jcfg)
        ty, tS, txl = rwkv6.rwkv_decode_step(tp, torch.from_numpy(x), tS, txl, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_array_equal(txl.numpy(), np.asarray(jxl))


def test_chunked_impl_names_roadmap():
    """impl="chunked" (module item 7) is ported: it equals JAX's chunked
    layer at 1e-4 in f32; its state, carried through bfloat16 products,
    equals JAX's exact _rwkv_state_after to 2e-2 of its largest entry (the
    chunked form's own tolerance, tests/test_chunked_impls.py); a name the
    port does not know raises."""
    jcfg, tcfg, jp, tp = _layer("float32")
    jx, tx = _x("float32")
    want = jax_rwkv6.rwkv_scan_full(jp, jx, jcfg, impl="chunked")
    got, state = rwkv6.rwkv_scan_full(tp, tx, tcfg, impl="chunked", return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    want_s = np.asarray(jax_transformer._rwkv_state_after(jcfg, jp, jx)["S"])
    rel = np.abs(state["S"].numpy() - want_s).max() / np.abs(want_s).max()
    assert rel < 2e-2, rel
    with pytest.raises(ValueError, match="chunked"):
        rwkv6.rwkv_scan_full(tp, tx, tcfg, impl="pallas")
