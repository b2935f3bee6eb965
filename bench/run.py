"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  Set-up
(imports, the kernels' build, inputs from the seed, warm-up) is timed as
``setup_s``; then the window runs ``--seconds``; then the output check.
The last line on standard output is one JSON object; the numbers the check
compared, each with its limit, are the last lines on standard error.  Exits
with 2, printing no result, without CUDA or with fewer devices than the
cell asks for, and with 3 if a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    harness.set_cache_dirs(ROOT)
    cell = harness.workload(harness.load_spec(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0)
    checks = out.pop("_checks")
    banned = harness.banned_modules()
    if banned:
        print(f"modules that no run may load are loaded: {banned}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
