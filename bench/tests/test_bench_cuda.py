"""On the card (marker ``cuda``; skips without one): one short run of each
cell through ``bench/run.py`` from the repository root, and its result
line: correct, on the GPU, every end-to-end metric, the checks last.

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import json
import subprocess
import sys

import pytest
import torch
from _tiny import ROOT, SEED, harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed", str(SEED),
                          "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    want = {m["name"] for m in harness.cell_metrics(harness.load_spec(), cell, False)}
    assert set(out["metrics"]) == want
    tail = res.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)
