"""Tiny sizes of the benchmark's cells for the CPU tests, and the import
paths (the repository root and ``src``)."""
import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

SEED = 2**33 + 12345  # more than 32 bits: seeds may be that large


def tiny(cell: str):
    """(config, traffic) of ``cell`` at a size the CPU runs in a second, as
    the cell's runner cuts it."""
    w = harness.workload(harness.load_spec(), cell)
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    tr = harness.load_json(harness.HERE / "traffic" / f"{w['traffic']}.json")
    return importlib.import_module(f"bench.runners.{cfg['runner']}").tiny(cfg, tr)


def run_tiny(cell: str, seconds: float = 2.0, trace: bool = False, seed: int = SEED,
             control: bool = False):
    cfg, tr = tiny(cell)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", config=cfg, traffic=tr,
                            control=control)
