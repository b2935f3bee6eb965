"""The port on a CUDA device: the hand-written kernels against their plain
versions, the flush path through them, the serving paths (dense, RWKV-6
and RG-LRU hybrid), and the HPC and lm-train apps.  Every test here needs a
card (marker ``cuda``) and skips without one; this file imports no jax, so
it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_torch
from repro_torch.core.arena import NVMArena
from repro_torch.core.manager import EasyCrashManager, FlushPolicy, flatten_state
from repro_torch.hpc.sor import SORApp
from repro_torch.kernels.delta_snapshot import dirty_block_mask
from repro_torch.kernels.delta_snapshot.ref import dirty_block_mask_reference
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_reference
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype,block_elems,n", [
    (torch.uint8, 64, n) for n in (1, 63, 64, 65, 4097, 1 << 20)
] + [(torch.float32, 256, n) for n in (1, 255, 257, 4097)])
def test_kernel_equals_plain_version(dtype, block_elems, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randint(0, 255, (n,), device="cuda", generator=gen).to(dtype)
    p = x.clone()
    p[torch.randint(0, n, (max(1, n // 100),), device="cuda", generator=gen)] += 1
    before = dirty_block_mask.launches
    got = dirty_block_mask(x, p, block_elems=block_elems)
    assert dirty_block_mask.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, dirty_block_mask_reference(x, p, block_elems))
    assert not dirty_block_mask(x, x.clone(), block_elems=block_elems).any()


def test_kernel_rejects_what_it_does_not_take():
    x = torch.zeros(64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        dirty_block_mask(x, x)
    y = torch.zeros(8, 8, device="cuda").t()
    with pytest.raises(ValueError):
        dirty_block_mask(y, y)


def test_delta_flush_of_device_leaf_goes_through_kernel():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000).astype(np.float32)
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False,
                                              persist_mode="delta"))
    before = dirty_block_mask.launches
    for step in range(1, 6):
        x = x.copy()
        x[(step * 131) % x.size] += 1.0
        mgr.maybe_flush(step, {"x": torch.from_numpy(x).cuda()})
        assert arena.peek("x").tobytes() == x.tobytes()
    assert dirty_block_mask.launches == before + 4  # every flush after the first
    got, step, src = mgr.restore(state_to_torch({"x": np.zeros_like(x)}, "cuda"))
    assert (step, src) == (5, "easycrash") and got["x"].is_cuda
    assert got["x"].cpu().numpy().tobytes() == x.tobytes()


def test_fresh_manager_delta_flush_goes_through_kernel():
    """A manager with no shadow (over an arena another manager wrote)
    still takes its first delta mask from the kernel."""
    x = torch.arange(5000, dtype=torch.float32, device="cuda")
    arena = NVMArena(block_bytes=64)
    pol = FlushPolicy(leaves=("x",), async_flush=False, persist_mode="delta")
    EasyCrashManager(arena, pol).maybe_flush(1, {"x": x})
    x[1234] = -1.0
    mgr = EasyCrashManager(arena, pol)
    before = dirty_block_mask.launches
    mgr.maybe_flush(2, {"x": x})
    assert dirty_block_mask.launches == before + 1
    assert mgr.stats.blocks_written == 1 + 1  # x's one block, __step__
    assert arena.peek("x").tobytes() == x.cpu().numpy().tobytes()


def test_async_flush_from_a_side_stream():
    """Async flushes of a leaf updated on a side stream: the writer thread
    works on that stream, so it waits for the update and the clone."""
    x = torch.zeros(1 << 22, device="cuda")
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=True,
                                              max_pending=8, persist_mode="delta"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for step in range(1, 5):
            torch.cuda._sleep(20_000_000)  # keep the side stream busy before the update
            x[step * 1000:] += 1.0
            mgr.maybe_flush(step, {"x": x})
            mgr.barrier()
            assert arena.peek("x").tobytes() == x.cpu().numpy().tobytes()
    mgr.close()
    assert int(arena.get("__step__")) == 4


def test_sor_iteration_stays_on_device():
    app = SORApp(grid=24, device="cuda")
    s = state_to_torch(app.init(0), "cuda")
    for _ in range(3):
        s = app.run_iteration(s)
    assert all(v.is_cuda for v in s.values())
    assert np.isfinite(app.progress(s))


# ------------------------------------------------------------ flash attention
#: tests/test_kernels.py's grid of (b, h, s, d, causal, window, block), plus
#: D 256, a window under the block, and a ragged S; then the bf16 route's
#: edges: windows under its kv tile (128 rows at D 64 and 128, 64 at D 256)
#: at D 128 and 256, a non-causal window, a ragged S at D 128 and 256, and
#: S 64 (the q tile's second warpgroup wholly past S)
FLASH_CASES = [
    (2, 4, 256, 64, True, None, 128),
    (1, 2, 128, 64, True, None, 64),
    (2, 2, 256, 64, True, 64, 64),
    (1, 3, 256, 128, False, None, 128),
    (1, 1, 512, 64, True, 128, 128),
    (1, 2, 256, 256, True, None, 128),
    (1, 2, 256, 64, False, 8, 32),
    (1, 2, 100, 64, True, None, 128),
    (1, 2, 256, 128, True, 48, 128),
    (1, 2, 256, 256, True, 32, 128),
    (1, 2, 256, 256, False, 40, 128),
    (2, 3, 100, 128, True, None, 128),
    (2, 3, 100, 256, False, None, 128),
    (1, 2, 64, 64, True, None, 64),
]


def _flash_inputs(b, s, h, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window,blk", FLASH_CASES)
def test_flash_kernel_equals_plain_version(b, h, s, d, causal, window, blk, dtype):
    """2e-5 (abs and rel) for float32, 2e-2 for bfloat16, as tests/test_kernels.py."""
    q, k, v = _flash_inputs(b, s, h, d, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, block_q=blk, block_k=blk)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal, window=window).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_tile_independence():
    q, k, v = _flash_inputs(1, 256, 2, 64, torch.float32, seed=1)
    a = flash_attention(q, k, v, block_q=32, block_k=32)
    b = flash_attention(q, k, v, block_q=128, block_k=128)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,window", [(64, None), (256, 2048), (128, 40)])
def test_flash_bf16_launches_are_bitwise_repeatable(d, window):
    """No atomics and no split over kv: the served stream's crash/resume
    check needs the same bits from every prefill."""
    q, k, v = _flash_inputs(2, 1024, 4, d, torch.bfloat16, seed=d)
    a = flash_attention(q, k, v, causal=True, window=window)
    b = flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bf16_fully_masked_rows_of_a_live_tile_get_no_weight(d):
    """Window 8 under the kv tile: rows whose 8 keys all lie in a later tile
    are wholly masked in the live tile before it, and take nothing from it."""
    q, k, v = _flash_inputs(1, 256, 1, d, torch.bfloat16, seed=2)
    got = flash_attention(q, k, v, causal=True, window=8, block_q=64, block_k=64)
    qs, ks, vs = (x[0, :, 0].double() for x in (q, k, v))
    for i in (0, 7, 8, 63, 64, 100, 127, 128, 135, 255):
        lo = max(0, i - 7)
        w = torch.softmax((qs[i] @ ks[lo:i + 1].T) * d ** -0.5, dim=0)
        torch.testing.assert_close(got[0, i, 0].float(), (w @ vs[lo:i + 1]).float(),
                                   atol=2e-2, rtol=2e-2)


def test_flash_kernel_takes_a_misaligned_view():
    """A TMA tensor map needs a 16-byte aligned base: a view that starts
    anywhere is copied first, and the result is the plain version's."""
    buf = torch.randn(1 + 3 * 128 * 2 * 64, device="cuda").to(torch.bfloat16)
    q = buf[1:].view(3, 128, 2, 64)[:1]
    k, v = buf[1:].view(3, 128, 2, 64)[1:2], buf[1:].view(3, 128, 2, 64)[2:]
    got = flash_attention(q, k, v)
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 128, 2, 96, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


def test_bf16_delta_flush_on_device_goes_through_kernel():
    x = torch.randn(5000, device="cuda").to(torch.bfloat16)
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False,
                                              persist_mode="delta"))
    before = dirty_block_mask.launches
    for step in range(1, 4):
        x[step * 999] += 1.0
        mgr.maybe_flush(step, {"x": x})
        assert arena.peek("x").tobytes() == x.view(torch.int16).cpu().numpy().tobytes()
    assert dirty_block_mask.launches == before + 2
    got, step, _ = mgr.restore({"x": torch.zeros_like(x)})
    assert step == 3 and got["x"].is_cuda and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_serve_on_device_uses_the_kernel_and_resumes(tmp_path):
    from repro_torch.launch import serve

    base = ["--decode-steps", "24", "--flush-every", "8", "--width", "256"]
    before = flash_attention.launches
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    assert flash_attention.launches == before + 2  # one prefill, 2 layers
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])


# ------------------------------------------------------------- rwkv6 scan
def _rwkv_inputs(b, s, h, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") * 0.5 for _ in range(3))
    w = torch.sigmoid(torch.randn(b, s, h, d, generator=gen, device="cuda"))
    u = torch.randn(h, d, generator=gen, device="cuda") * 0.3
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d,bt", [(2, 3, 64, 16, 32), (1, 2, 128, 64, 64), (1, 1, 96, 32, 32),
                                        (2, 5, 100, 64, 100), (4, 40, 256, 64, 256)])
def test_rwkv6_kernel_equals_plain_version(b, h, t, d, bt, dtype):
    """1e-4 (abs and rel): both upcast the inputs to f32 and differ only in
    the order of sums."""
    r, k, v, w, u = _rwkv_inputs(b, t, h, d, dtype)
    before = rwkv6_scan.launches
    got = rwkv6_scan(r, k, v, w, u, block_t=bt)
    assert rwkv6_scan.launches == before + 1
    torch.cuda.synchronize()
    want = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u).transpose(1, 2)
    assert got.dtype == torch.float32 and got.shape == r.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", [(2, 3, 64, 16), (1, 2, 100, 32), (2, 5, 37, 64),
                                     (4, 40, 256, 64)])
def test_rwkv6_kernel_final_state(b, h, t, d, dtype):
    """return_state: the kernel's S_T (B, H, D, D) within 1e-4 of the plain
    loop's, T also off the kernel's 16-token chunk; y the same bits as
    without the state; two launches the same bits."""
    r, k, v, w, u = _rwkv_inputs(b, t, h, d, dtype, seed=2)
    before = rwkv6_scan.launches
    y, S = rwkv6_scan(r, k, v, w, u, block_t=t, return_state=True)
    assert rwkv6_scan.launches == before + 1
    torch.cuda.synchronize()
    want_y, want_S = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
                                     return_state=True)
    assert S.dtype == torch.float32 and tuple(S.shape) == (b, h, d, d)
    torch.testing.assert_close(S, want_S, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y, want_y.transpose(1, 2), atol=1e-4, rtol=1e-4)
    assert torch.equal(y, rwkv6_scan(r, k, v, w, u, block_t=t))
    y2, S2 = rwkv6_scan(r, k, v, w, u, block_t=t, return_state=True)
    assert torch.equal(y, y2) and torch.equal(S, S2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32])
def test_flash_kernel_pads_a_small_head_dim(dtype, d):
    """A head dim under 64 runs as 64 with zero columns: the plain
    version's result, within the route's tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 128, 4, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1 and got.shape == q.shape
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_rwkv6_kernel_chunking_independence():
    r, k, v, w, u = _rwkv_inputs(1, 128, 2, 32, torch.float32, seed=1)
    assert torch.equal(rwkv6_scan(r, k, v, w, u, block_t=32),
                       rwkv6_scan(r, k, v, w, u, block_t=128))


def test_rwkv6_kernel_rejects_what_it_does_not_take():
    r, k, v, w, u = _rwkv_inputs(1, 32, 2, 128, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        rwkv6_scan(r, k, v, w, u)
    r, k, v, w, u = _rwkv_inputs(1, 32, 2, 64, torch.float16)
    with pytest.raises(TypeError):
        rwkv6_scan(r, k, v, w, u)
    r, k, v, w, u = _rwkv_inputs(1, 32, 2, 64, torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6_scan(r, k, v, w.bfloat16(), u)


# ------------------------------------------------------------- rglru scan
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,bt,bd", [(2, 64, 128, 32, 128), (1, 128, 256, 64, 128),
                                         (3, 32, 64, 32, 64), (2, 100, 192, 100, 64),
                                         (4, 256, 4096, 256, 128), (3, 50, 75, 50, 75)])
def test_rglru_kernel_equals_plain_version(b, t, d, bt, bd, dtype):
    """Bit for bit: both round the product and the add one at a time.  D 75
    (rows of 300 or 150 bytes) is off the 16-byte rows the kernel's bulk
    copies need and takes its direct path."""
    gen = torch.Generator(device="cuda").manual_seed(b * t + d)
    a = (torch.sigmoid(torch.randn(b, t, d, generator=gen, device="cuda")) * 0.98).to(dtype)
    x = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
    before = rglru_scan.launches
    got = rglru_scan(a, x, block_t=bt, block_d=bd)
    assert rglru_scan.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert torch.equal(got, rglru_reference(a, x))


def test_rglru_kernel_rejects_what_it_does_not_take():
    a = torch.zeros(1, 32, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        rglru_scan(a, a)
    with pytest.raises(TypeError, match="one dtype"):
        rglru_scan(a.float(), a.bfloat16())
    a = torch.zeros(1, 48, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        rglru_scan(a, a, block_t=32)


@pytest.mark.parametrize("arch,width,per_prefill", [
    ("rwkv6-3b", 128, {"rwkv6": 1}),
    ("recurrentgemma-9b", 256, {"rglru": 2, "flash": 1}),
])
def test_serve_recurrent_on_device_uses_the_kernels_and_resumes(arch, width, per_prefill,
                                                                 tmp_path):
    from repro_torch.launch import serve

    counters = {"rwkv6": rwkv6_scan, "rglru": rglru_scan, "flash": flash_attention}
    base = ["--arch", arch, "--decode-steps", "24", "--flush-every", "8", "--width", str(width)]
    before = {k: counters[k].launches for k in per_prefill}
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    assert {k: counters[k].launches - before[k] for k in per_prefill} == per_prefill
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])


# --------------------------------------------------------------- MoE layer
@pytest.mark.parametrize("route", ["dense", "sort-g1", "sort-g4", "decode"])
def test_moe_apply_on_device_equals_cpu(route):
    """float32: the card's router picks the same experts as the CPU's and
    the layer's output agrees to 1e-5 (abs and rel); capacity factor 0.5,
    so the sort routes drop slots."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe, scaled_down

    cfg = dataclasses.replace(scaled_down(get_arch("qwen2-moe-a2.7b"), width=128),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="dense" if route == "dense" else "sort",
        dispatch_groups=4 if route == "sort-g4" else 1, capacity_factor=0.5))
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0), 1)
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    decode = route == "decode"
    want, want_aux = moe.moe_apply(p, x, cfg, decode=decode)
    pc = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict) else v.cuda())
          for k, v in p.items()}
    _, experts, _ = moe._route(x.reshape(-1, cfg.d_model).cuda(), pc["router"], cfg.moe)
    _, want_experts, _ = moe._route(x.reshape(-1, cfg.d_model), p["router"], cfg.moe)
    assert torch.equal(experts.cpu(), want_experts)
    got, aux = moe.moe_apply(pc, x.cuda(), cfg, decode=decode)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-6)


def test_serve_moe_on_device_uses_the_kernel_and_resumes(tmp_path):
    """A scaled Qwen1.5-MoE (width 512, 4 heads of D 128, 2 layers): the
    prefill runs flash_attention once per layer at D 128, and the resumed
    stream equals the uninterrupted one."""
    from repro_torch.launch import serve

    base = ["--arch", "qwen2-moe-a2.7b", "--decode-steps", "24", "--flush-every", "8",
            "--width", "512"]
    before = flash_attention.launches
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    assert flash_attention.launches == before + 2
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])


@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_rwkv_on_device_against_the_kernel(chunk):
    """The chunked RWKV-6 form (plain torch, cuBLAS products) against the
    rwkv6_scan kernel at the model's decay: 2e-2 of the largest entry, for
    the output and the final state."""
    from repro_torch.models.rwkv6 import _rwkv_chunked

    gen = torch.Generator(device="cuda").manual_seed(chunk)
    b, s, h, d = 2, 256, 4, 64
    r, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * torch.randn(b, s, h, d, generator=gen, device="cuda")))
    u = torch.randn(h, d, generator=gen, device="cuda") * 0.3
    before = rwkv6_scan.launches
    want, want_state = rwkv6_scan(r, k, v, w, u, return_state=True)
    assert rwkv6_scan.launches == before + 1
    got, state = _rwkv_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
    for a, bb in ((got, want), (state, want_state)):
        rel = float((a - bb).abs().max() / bb.abs().max())
        assert rel < 2e-2, rel


# ------------------------------------------ the HPC suite and lm-train apps
_GOLDENS = os.path.join(os.path.dirname(__file__), "golden", "campaign_goldens.json")


def _campaign_entry(app):
    from repro_torch.core import CrashTester, PersistPlan
    from repro_torch.hpc.suite import default_cache

    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=123).run_campaign(8)
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


@pytest.mark.parametrize("name", ["heat", "cg", "pagerank", "kmeans", "mg", "montecarlo"])
def test_hpc_campaign_on_device_reproduces_golden(name):
    from repro_torch.hpc.suite import ci_app

    with open(_GOLDENS) as f:
        want = json.load(f)["apps"][name]
    assert _campaign_entry(ci_app(name, device="cuda")) == want


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_lm_train_gradient_on_device_matches_cpu(dtype, tol):
    """The same generator weights and tokens on the card and on the CPU.
    float32: the gradients differ in the order of f32 sums (cuBLAS against
    the CPU's BLAS), held to 1e-4 abs and rel.  bfloat16: the card's
    products run in bf16 with f32 sums (cuBLAS), the CPU's as f32 products
    of the upcast operands rounded once, so the intermediates round
    differently: held to 2e-2 in relative L2 norm, as against JAX's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.hpc.suite import CI_SIZES, get_app

    base = dataclasses.replace(get_arch("stablelm-1.6b"), dtype=dtype)
    apps = {dev: get_app("lm-train", base=base, device=dev, **CI_SIZES["lm-train"])
            for dev in ("cpu", "cuda")}
    vec = apps["cpu"].init(0)["params"]
    for k in (0, 3):
        want = apps["cpu"]._grad(vec, k).numpy()
        got = apps["cuda"]._grad(vec, k)
        assert got.is_cuda
        got = got.cpu().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        else:
            assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _serial_phase_a(app, s0, it, stop):
    s = dict(s0)
    while it < stop:
        s = app.run_iteration(s)
        it += 1
        if app.converged(s, it):
            break
    return s, it


@pytest.mark.parametrize("name,field", [("cg", "x"), ("heat", "u"), ("kmeans", "centroids"),
                                        ("pagerank", "rank"), ("mg", "u"),
                                        ("montecarlo", "sums")])
def test_lane_driver_graph_equals_eager_chunk_and_serial(name, field, monkeypatch):
    """advance_lanes on the card (the captured graph; montecarlo's bespoke
    replay) equals the same driver's eager chunks and the serial loop on
    the card, bit for bit, for perturbed lanes entering at scattered
    iterations."""
    from repro_torch.core import lane_driver
    from repro_torch.hpc.suite import ci_app

    monkeypatch.setattr(lane_driver, "_DRIVER_CACHE", {})
    app = ci_app(name, device="cuda")
    s, traj, stop = app.init(0), [], app.n_iters
    traj.append(s)
    for it in range(1, app.n_iters + 1):
        s = app.run_iteration(s)
        traj.append(s)
        if app.converged(s, it):
            stop = it
            break
    rng = np.random.default_rng(7)
    entry = sorted({1, stop // 3, stop // 2, stop - 1, stop})
    lanes = []
    for ei in entry:
        lane = {k: np.array(v, copy=True) for k, v in traj[ei].items()}
        lane[field] = (lane[field] + rng.standard_normal(lane[field].shape) * 1e-5
                       ).astype(lane[field].dtype)
        lanes.append(lane)
    replays = lane_driver.STATS.replays
    got, its, oks = app.advance_lanes(lanes, entry, stop)
    assert all(oks)
    runs = [(got, its)]
    if name != "montecarlo":
        assert lane_driver.STATS.replays > replays
        (drv,) = lane_driver._DRIVER_CACHE.values()
        eager = lane_driver.LaneDriver(drv.spec)
        eager.graphs = False
        e_states, e_its, e_oks = eager.advance(lanes, entry, stop)
        assert all(e_oks)
        runs.append((e_states, e_its))
    for lane, ei, i in zip(lanes, entry, range(len(lanes))):
        want, wit = _serial_phase_a(app, lane, ei, stop)
        for states, out_its in runs:
            assert out_its[i] == wit
            for k in want:
                assert np.asarray(states[i][k]).tobytes() == np.asarray(want[k]).tobytes(), (i, k)


# ---------------------------------------------------- the trainer (slice 8)
def test_trainer_on_device_async_delta_flushes_and_restores_the_image(tmp_path):
    """A few trainer steps on the card with asynchronous delta flushes: each
    flush's mask comes from delta_snapshot (one launch per tensor leaf once
    the arena holds the leaf), every arena image equals the bytes its flush
    cloned, and the restart after a crash restores that image exactly."""
    from repro_torch.convert import host_array
    from repro_torch.launch import train

    args = train.parser().parse_args([
        "--width", "256", "--seq", "32", "--batch", "4", "--steps", "9", "--flush-every", "3",
        "--persist-mode", "delta", "--inject-failure-every", "6", "--workdir", str(tmp_path)])
    landed = {}

    def on_flushed(step, payload, arena):
        for name, leaf in payload.items():
            if isinstance(leaf, torch.Tensor):
                assert leaf.is_cuda
                assert arena.peek(name).tobytes() == host_array(leaf).tobytes(), name
        landed[step] = {k: host_array(v) for k, v in payload.items()
                        if isinstance(v, torch.Tensor)}

    before = dirty_block_mask.launches
    with pytest.raises(train.SimulatedFailure):
        train.run(args, on_flushed=on_flushed)
    leaves = len(landed[3])  # the parameter leaves and step
    assert sorted(landed) == [3, 6]
    assert dirty_block_mask.launches - before == leaves  # at 6: the arena held them
    restored = {}

    def on_restore(state, step, source):
        restored.update(step=step, source=source,
                        params={k: host_array(v) for k, v in
                                flatten_state(state["params"]).items()})

    args.inject_failure_every = 0
    before = dirty_block_mask.launches
    stats = train.run(args, on_flushed=on_flushed, on_restore=on_restore)
    assert (restored["source"], restored["step"]) == ("easycrash", 6)
    for k, v in restored["params"].items():
        assert v.tobytes() == landed[6]["params/" + k].tobytes(), k
    assert stats["final_step"] == 9 and sorted(landed) == [3, 6, 9]
    assert dirty_block_mask.launches - before == leaves  # the flush at 9


def test_h100_mesh_reshard_restore_and_dryrun_cell(tmp_path):
    """The "h100" mesh (the card as 1 x 1, a one-rank NCCL group):
    reshard_restore places each leaf whole on the card, and the dry-run's
    cell runs and counts a reduced train step there."""
    import dataclasses

    from repro_torch.checkpoint import reshard_restore
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_for_name, release
    from repro_torch.models import scaled_down
    from repro_torch.models.config import ShapeConfig

    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8), "step": np.array(3, np.int32)}
    try:
        mesh = mesh_for_name("h100")
        placed = reshard_restore(tree, {"w": ("fsdp", "ff"), "step": ()}, mesh)
        w = placed["w"].to_local()
        assert w.is_cuda and np.array_equal(w.cpu().numpy(), tree["w"])
        cfg = dataclasses.replace(scaled_down(get_arch("stablelm-1.6b"), width=128), grad_accum=2)
        res = dryrun.cell(cfg, ShapeConfig("t", 32, 4, "train"), mesh)
    finally:
        release()
    r = res["roofline"]
    assert res["n_devices"] == 1 and r["flops_per_device"] > 0 and r["collective_bytes"] == 0
    assert 0 < res["bytes_per_device"] < 80e9 and res["fits_80gb_hbm"]


@pytest.mark.parametrize("op", ["rwkv6_scan", "rwkv6_scan_reference", "rglru_scan",
                                "rglru_scan_reference", "flash_attention"])
def test_op_on_h100_dtensor_equals_the_direct_call(op):
    """Each model kernel's op (and the plain versions' ops) on 1 x 1
    DTensors of the card gives the direct call's bits; the kernel ops
    launch their kernel once per call."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import register_op_strategies
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    from repro_torch.launch.mesh import mesh_for_name, release

    gen = torch.Generator(device="cuda").manual_seed(12)
    if op.startswith("rwkv6"):
        xs = [torch.randn(2, 64, 4, 64, generator=gen, device="cuda") for _ in range(3)]
        xs += [torch.rand(2, 64, 4, 64, generator=gen, device="cuda") * 0.5 + 0.5,
               torch.randn(4, 64, generator=gen, device="cuda")]
        fn = getattr(rwkv_ops, op)
        call, counter = (lambda *t: fn(*t, return_state=True)), rwkv_ops.rwkv6_scan
    elif op.startswith("rglru"):
        xs = [torch.rand(2, 64, 256, generator=gen, device="cuda"),
              torch.randn(2, 64, 256, generator=gen, device="cuda")]
        call, counter = getattr(rglru_ops, op), rglru_ops.rglru_scan
    else:
        xs = [torch.randn(2, 256, 4, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
              for _ in range(3)]
        call, counter = (lambda *t: flash_attention(*t, window=64)), flash_attention
    register_op_strategies()
    try:
        mesh = mesh_for_name("h100")
        before = counter.launches
        direct = call(*xs)
        via = call(*(DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
                     for x in xs))
    finally:
        release()
    direct, via = ((t,) if isinstance(t, torch.Tensor) else t for t in (direct, via))
    assert all(torch.equal(a, b.to_local()) for a, b in zip(direct, via))
    kernel_op = not op.endswith("_reference")
    assert counter.launches - before == (2 if kernel_op else 0)
