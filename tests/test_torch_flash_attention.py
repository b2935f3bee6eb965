"""The port's flash-attention op on the CPU (its plain version) against the
JAX package's Pallas kernel, run in interpret mode as its own tests run it.

Same inputs on both sides (numpy, from a seed).  Tolerances are those of
``tests/test_kernels.py``: 2e-5 (abs and rel) for float32, 2e-2 for
bfloat16, whose output is rounded once to bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax.experimental.pallas", reason="the JAX kernel needs a Pallas-capable jax")

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference

CASES = [
    (2, 4, 256, 64, True, None, 128),
    (1, 2, 128, 64, True, None, 64),
    (2, 2, 256, 64, True, 64, 64),
    (1, 3, 256, 128, False, None, 128),
    (1, 1, 512, 64, True, 128, 128),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d,causal,window,blk", CASES)
def test_plain_version_matches_jax_kernel(b, h, s, d, causal, window, blk, dtype):
    q, k, v = _qkv(b, s, h, d)
    want = jax_flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
                               window=window, block_q=blk, block_k=blk)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = attention_reference(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                              causal=causal, window=window).transpose(1, 2)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, s, h, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d,causal,window,blk", CASES)
def test_op_on_cpu_tensors_takes_the_plain_version(b, h, s, d, causal, window, blk, dtype):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _qkv(b, s, h, d, seed=1))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, block_q=blk, block_k=blk)
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal, window=window).transpose(1, 2)
    assert flash_attention.launches == before  # no kernel on the CPU
    assert torch.equal(got, want)


def test_op_keeps_the_jax_block_contract():
    q = torch.zeros(1, 192, 2, 64)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, q, q, block_q=128, block_k=128)
    flash_attention(q, q, q, block_q=64, block_k=64)  # 192 = 3 x 64
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :64], q)


def test_fully_masked_rows_of_a_live_block_get_no_weight():
    """A window smaller than the block leaves rows of a live block with no
    allowed key in it; they must not take weight from that block."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 1, 64, seed=2))
    got = flash_attention(q, k, v, causal=True, window=8, block_q=64, block_k=64)
    # brute force per row over its 8 allowed keys
    qs, ks, vs = q[0, :, 0].double(), k[0, :, 0].double(), v[0, :, 0].double()
    for i in (0, 7, 8, 63, 64, 100, 255):
        lo = max(0, i - 7)
        w = torch.softmax((qs[i] @ ks[lo:i + 1].T) * 64 ** -0.5, dim=0)
        np.testing.assert_allclose(got[0, i, 0].numpy(), (w @ vs[lo:i + 1]).numpy(),
                                   atol=2e-5, rtol=2e-5)


# ------------------------------------------------ the CUDA wrapper's routes
from pathlib import Path  # noqa: E402

from repro_torch.kernels.flash_attention import ops  # noqa: E402

KERNEL_SOURCE = Path(ops.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_takes_the_wgmma_route_with_its_tiles_per_head_dim(d):
    for block_k in (16, 32, 64, 128, 512):  # block_k picks no tile of this route
        route = ops.kernel_route(torch.bfloat16, d, block_k)
        assert route["route"] == "wgmma"
        assert route["q_rows"] == 128  # two consumer warpgroups of 64 rows
        assert (route["kv_tile"], route["stages"]) == ops.BF16_TILES[d]
    assert ops.BF16_TILES == {64: (128, 3), 128: (128, 2), 256: (64, 2)}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("block_k,kv_tile", [(8, 32), (32, 32), (64, 64), (128, 64), (1024, 64)])
def test_f32_takes_the_simt_route_with_kv_tile_from_block_k(d, block_k, kv_tile):
    route = ops.kernel_route(torch.float32, d, block_k)
    assert route["route"] == "simt" and route["q_rows"] == 64
    assert route["kv_tile"] == kv_tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_every_route_fits_a_ctas_shared_memory(dtype, d):
    for block_k in (32, 128):
        assert ops.kernel_route(dtype, d, block_k)["smem_bytes"] <= ops.SMEM_LIMIT


def test_bf16_tiles_mirror_the_kernel_source():
    import re

    text = KERNEL_SOURCE.read_text()
    found = {int(d): (int(bk), int(st)) for d, bk, st in re.findall(
        r"struct Bf16Tiles<(\d+)> \{ static constexpr int kBK = (\d+), kStages = (\d+); \}", text)}
    assert found == ops.BF16_TILES
    assert f"constexpr int kBQ = {ops.BF16_Q_ROWS};" in text


def test_route_rejects_what_no_kernel_takes():
    with pytest.raises(TypeError):
        ops.kernel_route(torch.float16, 64, 128)
    with pytest.raises(ValueError, match="head dims"):
        ops.kernel_route(torch.bfloat16, 96, 128)


def test_tma_operands_are_contiguous_and_16_byte_aligned():
    buf = torch.zeros(1 + 2 * 128 * 2 * 64, dtype=torch.bfloat16)
    view = buf[1:].view(2, 128, 2, 64)  # starts 2 bytes into the buffer
    assert view.data_ptr() % 16 != 0
    got = ops._tma_ready(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)
    fresh = torch.zeros(2, 128, 2, 64, dtype=torch.bfloat16)
    assert ops._tma_ready(fresh) is fresh  # already fit: no copy
    strided = fresh.transpose(1, 2)
    assert ops._tma_ready(strided).is_contiguous()
