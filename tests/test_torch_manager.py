"""The port's EasyCrashManager: delta flushes leave the NVM image a full
rewrite leaves, the device shadow tracks the arena, and restore hands back
what was flushed, for numpy and tensor leaves (CPU tensors here).  Images
written by the JAX package's manager restore into the port byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.arena import NVMArena as JaxArena
from repro.core.manager import EasyCrashManager as JaxManager
from repro.core.manager import FlushPolicy as JaxPolicy
from repro_torch.convert import state_to_numpy, state_to_torch
from repro_torch.core.arena import NVMArena
from repro_torch.core.manager import EasyCrashManager, FlushPolicy, flatten_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _series(n, dtype, rng):
    """A value trajectory that touches one element per step plus the tail
    (the JAX package's differential series)."""
    if np.dtype(dtype).kind == "i":
        x = rng.integers(-1000, 1000, size=n).astype(dtype)
    else:
        x = rng.standard_normal(n).astype(np.float32).astype(dtype)
    series = [x]
    for step in range(1, 5):
        x = x.copy()
        x[(step * 17) % n] += np.asarray(1, dtype)
        x[n - 1] += np.asarray(1, dtype)  # the partial tail block goes dirty too
        series.append(x)
    return series


def _leaf(x, kind):
    return torch.from_numpy(x.copy()) if kind == "tensor" else x


def _run(series, mode, kind, check_shadow=False):
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False, persist_mode=mode))
    for step, x in enumerate(series, start=1):
        mgr.maybe_flush(step, {"x": _leaf(x, kind)})
        assert arena.peek("x").tobytes() == x.tobytes()
        if check_shadow:
            shadow = mgr._shadow["x"]
            assert shadow.numpy().tobytes() == arena.peek("x").tobytes()
    mgr.close()
    return arena.get("x"), mgr.stats.blocks_written


# bfloat16 only as a numpy leaf: a bfloat16 tensor has no numpy host copy
@pytest.mark.parametrize("dtype,kind", [
    (np.float32, "numpy"), (np.int32, "numpy"), ("bfloat16", "numpy"),
    (np.float32, "tensor"), (np.int32, "tensor"),
])
@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000, 4097])
def test_delta_full_auto_images_identical(n, dtype, kind):
    """delta, full and auto flushes leave byte-identical images; delta moves
    no more blocks than full, the same as auto, and fewer on big objects."""
    if dtype == "bfloat16":
        dtype = jnp.bfloat16.dtype
    series = _series(n, dtype, np.random.default_rng(n))
    img_delta, blocks_delta = _run(series, "delta", kind, check_shadow=kind == "tensor")
    img_full, blocks_full = _run(series, "full", kind)
    img_auto, blocks_auto = _run(series, "auto", kind)
    assert img_delta.tobytes() == img_full.tobytes() == img_auto.tobytes()
    assert img_delta.dtype == np.dtype(dtype)
    assert blocks_delta <= blocks_full
    assert blocks_delta == blocks_auto
    if n > 256:
        assert blocks_delta < blocks_full


def test_shadow_dropped_on_reallocation():
    """A leaf whose byte size changes full-writes and restarts its shadow."""
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False, persist_mode="delta"))
    mgr.maybe_flush(1, {"x": torch.zeros(100)})
    mgr.maybe_flush(2, {"x": torch.ones(300)})
    assert mgr.stats.blocks_written == (7 + 1) + (19 + 1)  # leaf + __step__ each time
    assert mgr._shadow["x"].numel() == 300
    assert arena.peek("x").tobytes() == torch.ones(300).numpy().tobytes()


def _spy_delta_masks(monkeypatch):
    """Record the (cur, live) arguments of the manager's device-side mask calls."""
    import repro_torch.core.manager as manager_mod
    calls = []
    real = manager_mod.delta_block_mask

    def spy(cur, live, block_bytes):
        calls.append((cur, live))
        return real(cur, live, block_bytes)

    monkeypatch.setattr(manager_mod, "delta_block_mask", spy)
    return calls


def test_fresh_manager_without_shadow_flushes_exactly(monkeypatch):
    """A second manager over a used arena has no shadow: its first delta
    flush copies the arena image to the leaf's device, computes the mask
    there (the kernel's path on a card) and leaves the exact image."""
    calls = _spy_delta_masks(monkeypatch)
    rng = np.random.default_rng(3)
    series = _series(1000, np.float32, rng)
    arena = NVMArena(block_bytes=64)
    pol = FlushPolicy(leaves=("x",), async_flush=False, persist_mode="delta")
    EasyCrashManager(arena, pol).maybe_flush(1, {"x": torch.from_numpy(series[0])})
    assert calls == []  # the first flush full-writes
    mgr = EasyCrashManager(arena, pol)
    mgr.maybe_flush(2, {"x": torch.from_numpy(series[1])})
    assert len(calls) == 1
    cur, live = calls[0]
    assert isinstance(cur, torch.Tensor) and cur.device == live.device
    assert cur.numpy().tobytes() == series[0].tobytes()
    assert arena.peek("x").tobytes() == series[1].tobytes()
    assert mgr.stats.blocks_written == 2 + 1  # one element, the tail, __step__
    assert mgr._shadow["x"].numpy().tobytes() == series[1].tobytes()


def test_restore_seeds_the_shadow(monkeypatch):
    """In delta mode restore leaves a shadow of each restored tensor leaf,
    a copy apart from the tensor it returns; the next flush compares
    against it and writes just the blocks changed since the restore."""
    calls = _spy_delta_masks(monkeypatch)
    arena, flushed = _flushed_arena()
    pol = FlushPolicy(leaves=("a", "b"), async_flush=False, persist_mode="delta")
    mgr = EasyCrashManager(arena, pol)
    init = state_to_torch({"a": np.zeros(300, np.float32), "b": np.zeros(17, np.int64),
                           "c": np.zeros(4, np.float32)}, "cpu")
    got, step, src = mgr.restore(init)
    assert (step, src) == (6, "easycrash")
    assert set(mgr._shadow) == {"a", "b"}  # "c" is not in the plan
    for k in ("a", "b"):
        assert mgr._shadow[k].numpy().tobytes() == arena.peek(k).tobytes()
        assert mgr._shadow[k].data_ptr() != got[k].data_ptr()
    got["a"][5] += 1.0  # in place: the shadow must not follow
    before = mgr.stats.blocks_written
    mgr.maybe_flush(7, got)
    assert len(calls) == 2  # a and b, each against its shadow
    assert mgr.stats.blocks_written - before == 1 + 0 + 1  # a's block, b clean, __step__
    assert arena.peek("a").tobytes() == got["a"].numpy().tobytes()


def test_restore_converting_dtype_seeds_no_shadow():
    """A restore that converts the image's dtype holds other bytes than the
    image: no shadow, and the next flush copies the image to the device."""
    arena, _ = _flushed_arena()
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("a", "b"), async_flush=False,
                                              persist_mode="delta"))
    init = state_to_torch({"a": np.zeros(300, np.float32), "b": np.zeros(17, np.int32)}, "cpu")
    got, _, src = mgr.restore(init)
    assert src == "easycrash" and got["b"].dtype == torch.int32
    assert set(mgr._shadow) == {"a"}


def test_async_flush_with_tensor_leaves():
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(
        arena, FlushPolicy(leaves=("w",), async_flush=True, max_pending=8, persist_mode="delta")
    )
    w = torch.zeros(512)
    for step in range(1, 6):
        w[step] = float(step)  # in place: the flush must have cloned
        mgr.maybe_flush(step, {"w": w})
    mgr.barrier()
    mgr.close()
    assert arena.peek("w").tobytes() == w.numpy().tobytes()
    assert int(arena.get("__step__")) == 5


def _flushed_arena():
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("a", "b"), async_flush=False, persist_mode="delta"))
    rng = np.random.default_rng(0)
    state = {"a": rng.standard_normal(300).astype(np.float32),
             "b": np.arange(17, dtype=np.int64), "c": np.ones(4, np.float32)}
    mgr.maybe_flush(6, state)
    return arena, state


def test_restore_numpy_and_tensor_leaves_alike():
    arena, flushed = _flushed_arena()
    init = {"a": np.zeros(300, np.float32), "b": np.zeros(17, np.int64),
            "c": np.zeros(4, np.float32)}
    pol = FlushPolicy(leaves=("a", "b"), async_flush=False)
    got_np, step_np, src_np = EasyCrashManager(arena, pol).restore(init)
    got_t, step_t, src_t = EasyCrashManager(arena, pol).restore(state_to_torch(init, "cpu"))
    assert (step_np, src_np) == (step_t, src_t) == (6, "easycrash")
    for k in init:
        assert isinstance(got_np[k], np.ndarray)
        assert isinstance(got_t[k], torch.Tensor) and got_t[k].device.type == "cpu"
        assert got_t[k].numpy().tobytes() == got_np[k].tobytes()
    for k in ("a", "b"):
        assert got_np[k].tobytes() == flushed[k].tobytes()
    assert got_np["c"].tobytes() == init["c"].tobytes()  # not in the plan: init value


def test_restore_verify_rejects_to_fresh():
    arena, _ = _flushed_arena()
    init = state_to_torch({"a": np.zeros(300, np.float32)}, "cpu")
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("a",), async_flush=False))
    state, step, src = mgr.restore(init, verify=lambda s, k: False)
    assert (step, src) == (0, "fresh") and torch.equal(state["a"], init["a"])


def test_jax_manager_image_restores_into_port(tmp_path):
    """An arena the JAX package's manager wrote (backing files on disk)
    reattaches in the port and restores through state_to_torch byte for byte."""
    rng = np.random.default_rng(11)
    init = {"u": np.zeros(777, np.float32), "k": np.zeros(1, np.int64),
            "nested": {"w": np.zeros((5, 6), np.float64)}}
    backing = str(tmp_path / "nvm")
    jmgr = JaxManager(JaxArena(block_bytes=64, backing_dir=backing),
                      JaxPolicy(leaves=("u", "k", "nested/w"), async_flush=False,
                                persist_mode="delta"))
    live = None
    for step in range(1, 4):
        live = {"u": rng.standard_normal(777).astype(np.float32),
                "k": np.array([step], np.int64),
                "nested": {"w": rng.standard_normal((5, 6))}}
        jmgr.maybe_flush(step, live)
    jmgr.close()
    arena = NVMArena.reattach(backing)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("u",), async_flush=False))
    got, step, src = mgr.restore(state_to_torch(flatten_state(init), "cpu"))
    assert (step, src) == (3, "easycrash")
    back = state_to_numpy(flatten_state(got))
    for name, want in flatten_state(live).items():
        assert back[name].dtype == want.dtype and back[name].shape == want.shape
        assert back[name].tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64, np.int32, np.uint8, np.bool_])
def test_convert_round_trip_is_byte_exact(dtype):
    rng = np.random.default_rng(5)
    state = {"v": (rng.standard_normal(37) * 100).astype(dtype),
             "s": np.asarray(rng.standard_normal() * 100).astype(dtype)}
    t = state_to_torch(state, "cpu")
    back = state_to_numpy(t)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert back[k].tobytes() == v.tobytes()
    back["v"][...] = 0  # no aliasing between the two sides
    assert t["v"].numpy().tobytes() == state["v"].tobytes()


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dirty", ["none", "one", "tail", "all"])
def test_delta_flush_of_a_tensor_leaf_sends_only_what_its_mask_asks(monkeypatch, dirty, dtype,
                                                                    on_card):
    """After the first flush a delta flush of a leaf on the card never hands
    the arena the whole leaf: its dirty blocks go gathered (flush_blocks), a
    leaf with every block dirty is written straight into the image
    (rewrite).  A CPU leaf goes whole to flush with its mask.  Either way
    the image stays the same array and equals the live bytes.  (CPU
    tensors here, taken for a card's where ``on_card``.)"""
    import repro_torch.core.manager as manager_mod

    monkeypatch.setattr(manager_mod, "_off_host", lambda t: on_card)
    arena = NVMArena(block_bytes=64)
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False,
                                              persist_mode="delta"))
    x = torch.randn(1001, generator=torch.Generator().manual_seed(1)).to(dtype)
    mgr.maybe_flush(1, {"x": x})
    image = arena.peek("x")
    calls = []
    for method in ("flush", "flush_blocks", "rewrite"):
        real = getattr(arena, method)
        monkeypatch.setattr(arena, method, lambda name, *a, _m=method, _r=real, **k:
                            calls.append((_m, name)) or _r(name, *a, **k))
    if dirty == "one":
        x[300] += 1
    elif dirty == "tail":
        x[1000] += 1
    elif dirty == "all":
        x += 1
    before = mgr.stats.blocks_written
    mgr.maybe_flush(2, {"x": x})
    want = {"none": 0, "one": 1, "tail": 1, "all": -(-x.numel() * x.element_size() // 64)}[dirty]
    assert mgr.stats.blocks_written - before == want + 1  # and __step__'s block
    sent = [m for m, name in calls if name == "x"]
    assert sent == (["rewrite" if dirty == "all" else "flush_blocks"] if on_card else ["flush"])
    assert arena.peek("x") is image
    assert image.tobytes() == x.view(torch.int16 if dtype == torch.bfloat16 else dtype).numpy().tobytes()
