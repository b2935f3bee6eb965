"""Each runner at a tiny size on the CPU, end to end, against the plain
reference; the references against the port's own plain paths."""
import pytest
import torch
from _tiny import SEED, harness, run_tiny, tiny

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in harness.cell_metrics(harness.load_spec(), cell, False)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values()), out["metrics"]
    assert list(out)[-2:] == ["checks", "_checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_host_metrics(cell):
    out = run_tiny(cell, 3.0, trace=True)
    assert out["correct"], out["checks"]
    per_layer = harness.cell_metrics(harness.load_spec(), cell, True)
    want = {m["name"] for m in per_layer}
    host = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert host <= set(out["metrics"]) <= want
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


def test_same_seed_same_inputs_and_seeds_differ_in_layout():
    from bench.inputs import heat

    cfg, _ = tiny("heat-32768-flush8")
    a, b = heat.make_inputs(cfg, SEED)["pins"], heat.make_inputs(cfg, SEED)["pins"]
    assert torch.equal(a, b) and len(a) == cfg["pins"]
    g, box = cfg["app_args"]["grid"], cfg["pin_box"]
    rows, cols = a.long() // g, a.long() % g
    assert int(rows.max() - rows.min()) < box and int(cols.max() - cols.min()) < box
    # not the same pins moved: the layouts relative to the first pin differ
    rel = {tuple((p - p.min()).tolist()) for p in (heat.make_inputs(cfg, SEED + i)["pins"].long()
                                                 for i in range(4))}
    assert len(rel) == 4


def test_heat_reference_against_the_app():
    from repro_torch.hpc.heat import HeatApp

    from bench.inputs import heat as inputs
    from bench.reference.heat import heat_solve, relative_gap

    cfg, _ = tiny("heat-32768-flush8")
    app = HeatApp(**cfg["app_args"], device="cpu")
    ins = inputs.make_inputs(cfg, SEED)
    state = inputs.make_state(cfg, ins, "cpu")
    for _ in range(50):
        state = app.run_iteration(state)
    u, flux = heat_solve(64, ins["pins"], 0.2, 8, 50)
    assert relative_gap(state["u"], u) < 1e-5 and relative_gap(state["flux"], flux) < 1e-5



def test_differing_bytes_counts_across_chunks(monkeypatch):
    import numpy as np

    from bench.reference import images

    monkeypatch.setattr(images, "CHUNK", 16)
    a = np.arange(100, dtype=np.uint8)
    b = torch.from_numpy(a.copy())
    b[[3, 17, 99]] += 1
    assert images.differing_bytes(a, b) == 3
    assert images.differing_bytes(a, b[:50]) == 100
