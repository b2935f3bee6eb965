"""The port on a CUDA device: the hand-written kernels against their plain
versions, and the flush path through them.  Every test here needs a card
(marker ``cuda``) and skips without one; this file imports no jax, so it
runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_torch
from repro_torch.core.arena import NVMArena
from repro_torch.core.manager import EasyCrashManager, FlushPolicy
from repro_torch.hpc.sor import SORApp
from repro_torch.kernels.delta_snapshot import dirty_block_mask
from repro_torch.kernels.delta_snapshot.ref import dirty_block_mask_reference

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
