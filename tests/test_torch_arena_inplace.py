"""The port's NVMArena writes a flush's dirty blocks into its own image in
place.  Over sequences of flushes its images equal, byte for byte, both
``mix_blocks`` chained over the same flushes and the JAX package's arena fed
them; the stored array stays the same object until a reallocation; the
caller's buffer is read, never kept; and ``WriteStats.inplace_flushes``
counts the in-place writes."""
import numpy as np
import pytest
import torch

from repro.core import NVMArena as JaxArena
from repro_torch.core.arena import NVMArena, write_blocks
from repro_torch.core.blocks import block_diff_mask, mix_blocks, obj_num_blocks
from repro_torch.core.manager import EasyCrashManager, FlushPolicy

BB = 64

#: name -> (dtype, shape, order); sizes in bytes: 4000 (62 blocks and a
#: partial one), 4096 (64 whole), 6000 (93 and a partial), 8 (one partial),
#: 4100 in Fortran order (64 and a partial)
CASES = {
    "f32-partial": (np.float32, (1000,), "C"),
    "f64-2d": (np.float64, (16, 32), "C"),
    "bf16-bits": (np.int16, (3000,), "C"),
    "step-0d": (np.int64, (), "C"),
    "f32-fortran": (np.float32, (25, 41), "F"),
}
MASKS = ("all", "none", "sparse", "diff")


def _values(dtype, shape, order, rng, n):
    """``n`` successive live values: random, then a few elements changed
    each time."""
    size = int(np.prod(shape, dtype=np.int64))
    if np.issubdtype(dtype, np.integer):
        flat = rng.integers(-2**15, 2**15, size).astype(dtype)
    else:
        flat = rng.standard_normal(size).astype(dtype)
    out = []
    for _ in range(n):
        flat = flat.copy()
        flat[rng.integers(0, size, 3)] += dtype(7)
        v = flat.reshape(shape)
        out.append(np.asfortranarray(v) if order == "F" else np.ascontiguousarray(v))
    return out


def _mask(kind, nb, rng):
    if kind == "all":
        return np.ones(nb, dtype=bool)
    if kind == "none":
        return np.zeros(nb, dtype=bool)
    if kind == "sparse":
        m = rng.random(nb) < 0.1
        m[-1] = True  # the (possibly partial) last block
        return m
    return None  # the value diff against the image


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_sequence_matches_mix_blocks_and_jax(case, mask_kind):
    dtype, shape, order = CASES[case]
    rng = np.random.default_rng([sorted(CASES).index(case), MASKS.index(mask_kind)])
    arena, jax_arena = NVMArena(block_bytes=BB), JaxArena(block_bytes=BB)
    values = _values(dtype, shape, order, rng, 6)
    nb = obj_num_blocks(values[0], BB)
    expect = None
    inplace = 0
    for i, live in enumerate(values):
        mask = None if i == 0 else _mask(mask_kind, nb, rng)
        before = arena.peek("x")
        got = arena.flush("x", live, dirty_resident_mask=mask)
        assert got == jax_arena.flush("x", live, dirty_resident_mask=mask)
        if i == 0:
            expect = np.array(live, order="C")
        else:
            m = mask if mask is not None else block_diff_mask(expect, live, BB)
            expect = mix_blocks(expect, live, m, BB)
            assert arena.peek("x") is before  # written in place, or nothing written
            inplace += bool(got)
        img = arena.peek("x")
        assert img.flags.c_contiguous and img.flags.writeable
        assert (img.shape, img.dtype) == (expect.shape, expect.dtype)
        assert img.tobytes() == expect.tobytes() == jax_arena.peek("x").tobytes()
        assert arena.get("x").tobytes() == img.tobytes()
    assert arena.stats.as_dict() == jax_arena.stats.as_dict()
    assert arena.stats.inplace_flushes == inplace


@pytest.mark.parametrize("case", sorted(CASES))
def test_writeback_blocks_matches_jax(case):
    dtype, shape, order = CASES[case]
    rng = np.random.default_rng(len(case))
    arena, jax_arena = NVMArena(block_bytes=BB), JaxArena(block_bytes=BB)
    values = _values(dtype, shape, order, rng, 4)
    arena.install("x", values[0])
    jax_arena.install("x", values[0])
    kept = arena.peek("x")
    for live in values[1:]:
        mask = _mask("sparse", obj_num_blocks(live, BB), rng)
        arena.writeback_blocks("x", live, mask)
        jax_arena.writeback_blocks("x", live, mask)
        assert arena.peek("x") is kept
        assert kept.tobytes() == jax_arena.peek("x").tobytes()
    assert arena.stats.as_dict() == jax_arena.stats.as_dict()


def test_reallocation_makes_a_new_image_and_in_place_keeps_it():
    arena = NVMArena(block_bytes=BB)
    a = np.arange(1000, dtype=np.float32)
    arena.flush("x", a)
    first = arena.peek("x")
    assert first is not a and not np.shares_memory(first, a)
    b = a.copy()
    b[7] = -1
    assert arena.flush("x", b) == 1
    assert arena.peek("x") is first
    c = np.arange(1200, dtype=np.float32)  # grown: a whole new image
    assert arena.flush("x", c) == obj_num_blocks(c, BB)
    grown = arena.peek("x")
    assert grown is not first and grown.tobytes() == c.tobytes()
    c[1199] = 5
    assert arena.flush("x", c) == 1
    assert arena.peek("x") is grown and grown.tobytes() == c.tobytes()
    assert first.tobytes() == b.tobytes()  # the dropped image is left alone


def test_changing_the_live_buffer_after_a_flush_leaves_the_image():
    """The manager hands the arena its page-locked buffer, which it reuses:
    only the bytes may be kept."""
    arena = NVMArena(block_bytes=BB)
    buf = np.zeros(1000, dtype=np.float32)
    arena.flush("x", buf)
    for step in range(1, 4):
        buf[step * 100] = step
        mask = np.zeros(obj_num_blocks(buf, BB), dtype=bool)
        mask[(step * 100 * 4) // BB] = True
        arena.flush("x", buf, dirty_resident_mask=mask)
        flushed = buf.tobytes()
        buf[:] = -3.0
        assert arena.peek("x").tobytes() == flushed
        buf[:] = np.frombuffer(flushed, dtype=np.float32)


@pytest.mark.parametrize("other,explicit_mask", [
    (np.arange(1000, dtype=np.int32), False),
    (np.arange(1000, dtype=np.int32), True),
    (np.zeros((10, 100), dtype=np.float32), True),
], ids=["dtype-diff", "dtype-mask", "shape-mask"])
def test_same_size_other_dtype_or_shape_raises(other, explicit_mask):
    arena = NVMArena(block_bytes=BB)
    x = np.arange(1000, dtype=np.float32)
    arena.flush("x", x)
    kept = arena.peek("x").tobytes()
    mask = np.ones(obj_num_blocks(x, BB), dtype=bool) if explicit_mask else None
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        arena.flush("x", other, dirty_resident_mask=mask)
    assert arena.peek("x").tobytes() == kept


def test_write_blocks_refuses_what_it_cannot_write_in_place():
    x = np.arange(1000, dtype=np.float32)
    mask = np.ones(obj_num_blocks(x, BB), dtype=bool)
    with pytest.raises(ValueError, match="mask must have 63 blocks"):
        write_blocks(x.copy(), x, mask[:-1], BB)
    frozen = x.copy()
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="C-contiguous, writable"):
        write_blocks(frozen, x, mask, BB)
    with pytest.raises(ValueError, match="C-contiguous, writable"):
        write_blocks(np.asfortranarray(x.reshape(25, 40)), x.reshape(25, 40), mask, BB)


def test_inplace_flushes_counts_only_writes_into_an_existing_image():
    arena = NVMArena(block_bytes=BB)
    x = np.zeros(1000, dtype=np.float32)
    nb = obj_num_blocks(x, BB)
    sparse = np.zeros(nb, dtype=bool)
    sparse[[0, nb - 1]] = True
    steps = [  # (value, mask, inplace_flushes after)
        (x, None, 0),                                   # first: a whole copy
        (x + 1, sparse, 1),
        (x + 1, np.zeros(nb, dtype=bool), 1),           # nothing written
        (x + 2, np.ones(nb, dtype=bool), 2),
        (x + 2, None, 2),                               # the diff finds nothing
        (np.zeros(1100, dtype=np.float32), None, 2),    # reallocation
        (np.ones(1100, dtype=np.float32), None, 3),
    ]
    for i, (v, m, want) in enumerate(steps):
        arena.flush("x", v, dirty_resident_mask=m)
        assert arena.stats.inplace_flushes == want, i
    assert arena.stats.flush_ops == len(steps)
    assert "inplace_flushes" not in arena.stats.as_dict()


def test_manager_delta_flushes_write_one_image_in_place(tmp_path):
    """Through EasyCrashManager (CPU tensors), with and without a backing
    file: each delta flush after the first writes into the same image, and
    the backed file holds what the arena holds."""
    for backing in (None, str(tmp_path / "nvm")):
        arena = NVMArena(block_bytes=BB, backing_dir=backing)
        mgr = EasyCrashManager(arena, FlushPolicy(leaves=("x",), async_flush=False,
                                                  persist_mode="delta"))
        x = torch.zeros(1000)
        mgr.maybe_flush(1, {"x": x})
        image = arena.peek("x")
        for step in range(2, 6):
            x[step * 37] += 1.0
            mgr.maybe_flush(step, {"x": x})
            assert arena.peek("x") is image
            assert image.tobytes() == x.numpy().tobytes()
        # the step leaf (one block, rewritten every flush) and x, after their first
        assert arena.stats.inplace_flushes == 2 * 4
        if backing:
            again = NVMArena.reattach(backing)
            assert again.peek("x").tobytes() == x.numpy().tobytes()
            assert int(again.get("__step__")) == 5
