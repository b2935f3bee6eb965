"""The output check fails a run whose timed path is broken underneath: a
step that returns its state unchanged, an answer altered where it is
produced, an image altered in the arena.  (Every cell runs one solver on
one GPU: no batch to halve, no exchange between GPUs to leave out.)  The
look for a card is skipped: the runs are tiny, on the CPU."""
import numpy as np
import pytest
from _tiny import run_tiny


def _failed(cell, *names):
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]
    failed = {c.name for c in out["_checks"] if not c.ok}
    assert failed & set(names), (failed, names)


@pytest.mark.parametrize("cell", ["heat-32768-flush8", "heat-32768-noflush"])
def test_heat_step_returns_state_unchanged(cell, monkeypatch):
    from repro_torch.hpc.heat import HeatApp

    monkeypatch.setattr(HeatApp, "_region_update", lambda self, s: dict(s))
    _failed(cell, "state_gap")


@pytest.mark.parametrize("cell", ["heat-32768-flush8", "heat-32768-noflush"])
def test_heat_answer_altered_where_produced(cell, monkeypatch):
    from repro_torch.hpc.heat import HeatApp

    orig = HeatApp._region_pin

    def pin(self, s):
        s = orig(self, s)
        s["u"] = s["u"].clone()
        s["u"][len(s["u"]) // 3] += 1e-2
        return s

    monkeypatch.setattr(HeatApp, "_region_pin", pin)
    _failed(cell, "state_gap")


def test_heat_image_altered_in_the_arena(monkeypatch):
    from repro_torch.core.arena import NVMArena

    orig = NVMArena.flush

    def flush(self, name, live, dirty_resident_mask=None):
        n = orig(self, name, live, dirty_resident_mask)
        if name == "u":  # one byte of the image off the flushed one
            byte = np.asarray(live).reshape(-1).view("uint8")[5]
            self._store[name].reshape(-1).view("uint8")[5] = byte ^ 1
        return n

    monkeypatch.setattr(NVMArena, "flush", flush)
    _failed("heat-32768-flush8", "image_bytes_differ", "restore_bytes_differ")
