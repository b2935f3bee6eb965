"""The port's NVMArena backing store: reattach after a hard kill.

Port-side copies of ``tests/test_arena_durability.py``, run against
``repro_torch.core.NVMArena``, whose flushes write their dirty blocks into
the image in place.  The backing file is still rewritten whole through the
durable-replace protocol (write tmp, fsync data, atomic rename, fsync
directory), so a writer SIGKILLed mid-churn of masked in-place flushes must
leave every object a whole image of one acknowledged-or-later generation.
"""
import inspect
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro_torch.core import NVMArena
from repro_torch.core.blocks import block_diff_mask

#: name -> (dtype, elements): 32768 and 4004 bytes, the last one's final
#: block partial
OBJECTS = {"u": ("float64", 4096), "r": ("float32", 1001)}



def generation(g, n, dtype):
    """Generation ``g`` of an object: zeros, ``g`` at element 0 and at five
    more elements placed by ``g``, so two generations differ in a few blocks."""
    a = np.zeros(n, dtype=dtype)
    a[0] = g
    a[[(g * 131 + k * 977) % n for k in range(5)]] = g
    return a


_WRITER = textwrap.dedent("""
    import sys

    import numpy as np

    from repro_torch.core import NVMArena
    from repro_torch.core.blocks import block_diff_mask
""") + inspect.getsource(generation) + textwrap.dedent("""
    backing = sys.argv[1]
    objects = {"u": ("float64", 4096), "r": ("float32", 1001)}
    arena = NVMArena(backing_dir=backing)
    gen = 0
    while True:
        gen += 1
        for name, (dtype, n) in objects.items():
            live = generation(gen, n, dtype)
            cur = arena.peek(name)
            # u: the manager's way, an explicit dirty mask; r: the value diff
            mask = (block_diff_mask(cur, live, arena.block_bytes)
                    if cur is not None and name == "u" else None)
            arena.flush(name, live, dirty_resident_mask=mask)
        arena.install("chk/z", np.full(512, gen, dtype=np.float64))
        arena.save_manifest()
        print(f"ACK {gen} {arena.stats.inplace_flushes}", flush=True)
""")


def test_reattach_after_sigkill_of_in_place_flushes(tmp_path):
    """Kill the writer mid-churn; every reattached object must be a complete
    image of an acknowledged-or-later generation (never empty, never torn)."""
    backing = str(tmp_path / "nvm")
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.join(os.path.dirname(__file__), "..", "src")
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", _WRITER, backing],
        stdout=subprocess.PIPE, text=True, env=env,
    )
    try:
        acked = inplace = 0
        deadline = time.time() + 60
        while acked < 3:
            line = proc.stdout.readline()
            if line.startswith("ACK "):
                acked, inplace = map(int, line.split()[1:])
            if time.time() > deadline:
                pytest.fail("writer never reached generation 3")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    # every flush after each object's first went in place
    assert inplace == len(OBJECTS) * (acked - 1)
    arena = NVMArena.reattach(backing)
    assert set(arena.names()) == {"u", "r", "chk/z"}
    for name, (dtype, n) in OBJECTS.items():
        arr = arena.get(name)
        assert arr.shape == (n,) and arr.dtype == np.dtype(dtype)
        gen = int(arr[0])
        assert gen >= acked, f"{name}: holds gen {gen}, but gen {acked} was acknowledged"
        assert arr.tobytes() == generation(gen, n, dtype).tobytes(), (
            f"{name}: torn image mixes generations"
        )
    vals = np.unique(arena.get("chk/z"))
    assert vals.size == 1 and int(vals[0]) >= acked


def test_reattach_ignores_leftover_tmp_files(tmp_path):
    """A crash between tmp-write and rename leaves *.tmp litter; reattach
    must read only the committed images."""
    backing = str(tmp_path / "nvm")
    arena = NVMArena(backing_dir=backing)
    arena.flush("u", np.arange(64, dtype=np.float32))
    live = np.arange(64, dtype=np.float32)
    live[3] = -1
    arena.flush("u", live, dirty_resident_mask=block_diff_mask(arena.peek("u"), live))
    arena.save_manifest()
    # simulated crash mid-persist: torn tmp files next to committed ones
    for junk in ("u.npy.tmp", "manifest.json.tmp"):
        with open(os.path.join(backing, junk), "wb") as f:
            f.write(b"\x00torn")
    re = NVMArena.reattach(backing)
    np.testing.assert_array_equal(re.get("u"), live)


def test_persist_is_atomic_against_reader(tmp_path):
    """Every committed backing file is loadable at any point between masked
    in-place flushes (no window where the final path holds partial data),
    and a reattached arena writes its flushes in place too."""
    backing = str(tmp_path / "nvm")
    arena = NVMArena(backing_dir=backing)
    for gen in range(1, 6):
        live = generation(gen, 4096, "float64")
        cur = arena.peek("u")
        mask = None if cur is None else block_diff_mask(cur, live)
        arena.flush("u", live, dirty_resident_mask=mask)
        arena.save_manifest()
        seen = NVMArena.reattach(backing)
        assert seen.get("u").tobytes() == live.tobytes()
        nxt = generation(gen + 1, 4096, "float64")
        image = seen.peek("u")
        seen.flush("u", nxt, dirty_resident_mask=block_diff_mask(image, nxt))
        assert seen.peek("u") is image and image.tobytes() == nxt.tobytes()
        assert seen.stats.inplace_flushes == 1
    assert arena.stats.inplace_flushes == 4


def test_reattach_of_a_fortran_ordered_file_writes_in_place(tmp_path):
    """A backing file saved in Fortran order (as an F-ordered install left it
    before installs copied in C order) reattaches as a C-ordered, writable
    image of the same values, which a masked flush then writes in place."""
    backing = str(tmp_path / "nvm")
    arena = NVMArena(backing_dir=backing)
    arena.install("w", np.zeros((25, 41), dtype=np.float32))
    arena.save_manifest()
    f = np.asfortranarray(np.arange(25 * 41, dtype=np.float32).reshape(25, 41))
    np.save(os.path.join(backing, "w.npy"), f)
    re = NVMArena.reattach(backing)
    image = re.peek("w")
    assert image.flags.c_contiguous and image.flags.writeable
    assert np.array_equal(image, f)
    live = np.array(f, order="C")
    live[24, 40] = -1.0
    assert re.flush("w", live, dirty_resident_mask=block_diff_mask(image, live)) == 1
    assert re.peek("w") is image and image.tobytes() == live.tobytes()
