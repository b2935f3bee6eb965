"""The output check's control, on the GPU: each cell's number read from
the program and from the plain reference computed one precision below the
configuration's, put in the program's place (bfloat16 for the float32
stencil), on the same outputs.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 50

Runs the cell once per seed in one process, as ``run.py`` does, and prints
one JSON line per seed: the program's checks and the control's readings.
A cell's limit lies above the program's readings and below the control's.
No run of the benchmark computes the control.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                               control=True)
        line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                "program": out["checks"], "control": out["_control"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "attempted": out["attempted"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
