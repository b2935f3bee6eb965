"""The port's EasyCrash profiler ranges and the counters they feed: a flush
and a restore record their parts as ``easycrash.*`` ranges nested where the
work happens, ManagerStats' seconds add up those ranges' host time, and
``blocks_issued`` counts every block a flush covers beside the blocks it
writes (CPU tensors here)."""
import numpy as np
import pytest
import torch

from repro_torch.core.arena import NVMArena
from repro_torch.core.blocks import obj_num_blocks
from repro_torch.core.manager import EasyCrashManager, FlushPolicy
from repro_torch.core.spans import PREFIX, span

N = 1000  # float32 elements: 63 blocks of 64 bytes, the last one partial


def _profiled(fn):
    """The ``easycrash.*`` ranges ``fn`` records, in order of their start, as
    (name without the prefix, parent's name without the prefix or None)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ev = sorted((e for e in prof.events() if e.name.startswith(PREFIX)),
                key=lambda e: e.time_range.start)
    strip = lambda e: e.name[len(PREFIX):] if e is not None else None  # noqa: E731
    return [(strip(e), strip(e.cpu_parent)) for e in ev]


def _manager(tmp_path=None, mode="delta", async_flush=False):
    arena = NVMArena(block_bytes=64, backing_dir=str(tmp_path) if tmp_path else None)
    pol = FlushPolicy(leaves=("x",), async_flush=async_flush, max_pending=8, persist_mode=mode)
    return arena, EasyCrashManager(arena, pol)


def test_delta_flush_records_its_parts_nested(tmp_path):
    arena, mgr = _manager(tmp_path / "nvm")
    x = torch.zeros(N)
    mgr.maybe_flush(1, {"x": x})
    x[5] = 1.0
    got = _profiled(lambda: mgr.maybe_flush(2, {"x": x}))
    leaf = [("flush.mask", "flush"), ("flush.to_host", "flush"), ("arena.flush", "flush"),
            ("arena.mix", "arena.flush"), ("arena.persist", "arena.flush")]
    step = [("flush.mask", "flush"), ("arena.flush", "flush"),
            ("arena.mix", "arena.flush"), ("arena.persist", "arena.flush")]
    assert got == [("flush", None)] + leaf + step + [("arena.manifest", "flush")]
    assert arena.peek("x").tobytes() == x.numpy().tobytes()


def test_flush_off_cadence_and_unbacked_arena_record_only_what_runs():
    """No flush, no range; an arena with no backing file records no persist
    or manifest range."""
    arena, mgr = _manager()
    mgr.policy.every_steps = 2
    assert _profiled(lambda: mgr.maybe_flush(1, {"x": torch.zeros(N)})) == []
    got = _profiled(lambda: mgr.maybe_flush(2, {"x": torch.zeros(N)}))
    # a first flush writes everything: the leaf's mask comes after its copy
    # to the host and compares nothing, and nothing is mixed
    assert got == [("flush", None), ("flush.to_host", "flush"), ("flush.mask", "flush"),
                   ("arena.flush", "flush"), ("flush.mask", "flush"), ("arena.flush", "flush")]


def test_restore_records_its_parts_nested():
    arena, mgr = _manager()
    mgr.maybe_flush(3, {"x": torch.arange(N, dtype=torch.float32)})
    fresh = EasyCrashManager(arena, mgr.policy)
    out = {}
    got = _profiled(lambda: out.update(r=fresh.restore({"x": torch.zeros(N)})))
    assert got == [("restore", None), ("restore.read", "restore"),
                   ("restore.to_device", "restore"), ("restore.shadow", "restore")]
    state, step, source = out["r"]
    assert (step, source) == (3, "easycrash")
    assert state["x"].numpy().tobytes() == arena.peek("x").tobytes()


@pytest.mark.parametrize("mode,leaf_dirty", [("delta", 1), ("auto", 1), ("full", None)])
def test_blocks_issued_against_blocks_written(mode, leaf_dirty):
    """Every flush issues the leaf's blocks and __step__'s one; a change in
    one block writes that block (delta, auto) or the whole leaf (full)."""
    _, mgr = _manager(mode=mode)
    leaf_blocks = obj_num_blocks(np.zeros(N, np.float32), 64)
    x = torch.zeros(N)
    mgr.maybe_flush(1, {"x": x})
    assert mgr.stats.blocks_issued == mgr.stats.blocks_written == leaf_blocks + 1
    x[700] = 2.0
    mgr.maybe_flush(2, {"x": x})
    assert mgr.stats.blocks_issued == 2 * (leaf_blocks + 1)
    written = mgr.stats.blocks_written - (leaf_blocks + 1)
    assert written == (leaf_dirty or leaf_blocks) + 1  # and __step__'s block


def test_flush_counters_grow_with_each_flush():
    _, mgr = _manager()
    x = torch.zeros(N)
    for step in (1, 2):
        x[step] = 1.0
        mgr.maybe_flush(step, {"x": x})
    st = mgr.stats
    assert st.mask_seconds > 0 and st.copy_seconds > 0 and st.arena_seconds > 0
    before = (st.mask_seconds, st.copy_seconds, st.arena_seconds)
    mgr.maybe_flush(3, {"x": x})  # no dirty leaf block: the counters still grow
    assert all(a > b for a, b in zip((st.mask_seconds, st.copy_seconds, st.arena_seconds),
                                     before))


def test_async_flush_counts_on_the_writer_thread():
    arena, mgr = _manager(async_flush=True)
    x = torch.zeros(N)
    for step in range(1, 4):
        x[step] = float(step)
        mgr.maybe_flush(step, {"x": x})
    mgr.close()
    leaf_blocks = obj_num_blocks(np.zeros(N, np.float32), 64)
    assert mgr.stats.blocks_issued == 3 * (leaf_blocks + 1)
    assert mgr.stats.mask_seconds > 0 and mgr.stats.arena_seconds > 0
    assert arena.peek("x").tobytes() == x.numpy().tobytes()


def test_restore_counters_grow_with_each_restore():
    arena, mgr = _manager()
    mgr.maybe_flush(4, {"x": torch.arange(N, dtype=torch.float32)})
    fresh = EasyCrashManager(arena, mgr.policy)
    st = fresh.stats
    assert st.restore_read_seconds == st.restore_h2d_seconds == 0.0
    seen = [(0.0, 0.0)]
    for _ in range(2):
        fresh.restore({"x": torch.zeros(N)})
        seen.append((st.restore_read_seconds, st.restore_h2d_seconds))
    assert all(b[0] > a[0] and b[1] > a[1] for a, b in zip(seen, seen[1:]))
    assert st.easycrash_restores == 2


@pytest.mark.parametrize("image,same_bytes", [
    (np.arange(40, dtype=np.int16), True),           # a bfloat16 leaf's host bits
    (np.linspace(-2, 2, 40, dtype=np.float32), False),  # converted to bfloat16
])
def test_restore_of_a_bfloat16_leaf_stages_then_copies(image, same_bytes):
    """The staged image and the device copy give the tensor the single
    expression gave: the bits kept, or the values cast."""
    arena = NVMArena(block_bytes=64)
    arena.install("x", image)
    arena.install("__step__", np.asarray(9, np.int64))
    mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False,
                                              persist_mode="delta"))
    state, step, _ = mgr.restore({"x": torch.zeros(40, dtype=torch.bfloat16)})
    assert step == 9 and state["x"].dtype == torch.bfloat16
    if same_bytes:
        assert state["x"].view(torch.int16).numpy().tobytes() == image.tobytes()
    else:
        assert torch.equal(state["x"], torch.from_numpy(image).to(torch.bfloat16))
    assert ("x" in mgr._shadow) == same_bytes


def test_span_adds_to_its_field_and_nests():
    class Stats:
        t = 0.0

    st = Stats()

    def two():
        with span("a", st, "t"):
            with span("a.b"):
                pass

    assert _profiled(two) == [("a", None), ("a.b", "a")]
    assert st.t > 0
