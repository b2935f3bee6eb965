# Port of repro/analysis/lint.py.  What differs: --device picks where the
# apps build their kernels (the card unless --device cpu), and the apps
# come from the port's suite registry.
"""Pre-PR check entry point: ``python -m repro_torch.analysis.lint``.

Default: run the bitwise-batchability determinism lint over every registered
app that opts into the vectorized campaign engine
(``supports_batched_step``).  ``--all`` additionally runs ``ruff`` over the
repo — one command for the whole pre-PR gate.  Exit status is non-zero on
any finding.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List


def run_determinism_lint(app_names: List[str] | None = None, device: str = "cuda") -> int:
    from ..hpc.suite import app_names as registry_names, get_app
    from .determinism_lint import lint_app

    names = app_names or registry_names()
    failures = 0
    checked = 0
    for name in names:
        app = get_app(name, device=device)
        if not app.supports_batched_step:
            continue
        kernels = app.batched_kernels()
        if not kernels:
            print(f"[determinism] {name}: supports_batched_step but exposes "
                  f"no batched_kernels() — nothing to check", file=sys.stderr)
            failures += 1
            continue
        for kname, findings in lint_app(app).items():
            checked += 1
            if findings:
                failures += len(findings)
                for f in findings:
                    print(f"[determinism] FAIL {f}", file=sys.stderr)
            else:
                print(f"[determinism] ok   {name}/{kname}")
    print(f"[determinism] {checked} kernels checked, {failures} findings")
    return 1 if failures else 0


def run_ruff() -> int:
    import importlib.util

    if importlib.util.find_spec("ruff") is None:
        print("[ruff] not installed; skipping", file=sys.stderr)
        return 0
    cmd = [sys.executable, "-m", "ruff", "check",
           "src", "tests", "benchmarks", "examples"]
    print("[ruff]", " ".join(cmd[1:]))
    try:
        return subprocess.call(cmd)
    except FileNotFoundError:
        print("[ruff] not installed; skipping", file=sys.stderr)
        return 0


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="bitwise-batchability determinism lint (+ ruff with --all)",
    )
    ap.add_argument("--all", action="store_true",
                    help="also run ruff: the full one-command pre-PR check")
    ap.add_argument("--app", action="append", default=None,
                    help="restrict the determinism lint to specific apps")
    ap.add_argument("--device", default="cuda",
                    help="where the apps build their kernels (default: cuda)")
    args = ap.parse_args(argv)

    rc = run_determinism_lint(args.app, device=args.device)
    if args.all:
        rc = max(rc, run_ruff())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
