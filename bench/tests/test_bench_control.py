"""The control (the plain reference one precision below the
configuration's, in the program's place) comes out not correct against
each cell's limit, here at a tiny size; on the GPU, ``bench/control.py``
reads it at the cell's own size."""
import pytest
from _tiny import harness, run_tiny

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    out = run_tiny(cell, control=True)
    assert out["correct"], out["checks"]
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    for name, value in out["_control"].items():
        assert value > limits[name], (name, value, limits[name])
        assert value >= 3 * out["checks"][name]["value"], (name, value, out["checks"])
