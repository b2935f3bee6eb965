"""Crash campaign on any registered app — by default LM *training* (the
paper's technique applied to the architecture zoo): characterize
recomputability, select critical data objects, and show what must persist.
The PyTorch port's campaign, on the card by default (``--device cpu`` for
the host).

Apps come from the suite registry (``repro_torch.hpc.suite.get_app``): the
seven HPC kernels plus the model stack (``lm-train``, ``decode``) share one
namespace, one campaign machinery, and one CLI.

Campaigns fan out over processes with ``--workers N`` and checkpoint shard
results to a JSONL store with ``--store PATH``: kill the campaign mid-run,
re-run the same command, and only the missing shards execute (results are
identical to an uninterrupted run, for any worker count).

``--fault-model`` swaps what a "crash" is (repro_torch.core.faults): torn-write
tears in-flight cachelines, multi-crash re-crashes the recovery run,
bit-flip injects silent corruption, correlated-region concentrates failures
in the heaviest code region.  The store fingerprint includes the model, so a
resumed store refuses a different one.

Usage:  PYTHONPATH=src python examples/torch_crash_campaign.py [--app lm-train]
                                                               [--arch rwkv6-3b]
                                                               [--workers 4]
                                                               [--store camp.jsonl]
                                                               [--fault-model torn-write]
                                                               [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core import ENGINES, CacheConfig, CrashTester, PersistPlan
from repro_torch.core.faults import FAULT_MODELS, get_fault_model
from repro_torch.core.selection import select_objects
from repro_torch.hpc.suite import CI_SIZES, app_names, get_app


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="lm-train",
                    help="registered app name (HPC suite + model stack)")
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="base architecture for the model apps "
                         "(lm-train / decode); ignored by the HPC kernels")
    ap.add_argument("--tests", type=int, default=30)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--workers", type=int, default=1,
                    help="campaign shards fan out over this many processes")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="JSONL shard store; an interrupted campaign resumes "
                         "from it and executes only the missing shards")
    ap.add_argument("--fault-model", default="power-fail",
                    choices=sorted(FAULT_MODELS),
                    help="failure model for the campaign (default: the "
                         "paper's clean power failure)")
    ap.add_argument("--engine", default=None, choices=list(ENGINES),
                    help="campaign hot path: 'vec' (SoA window simulator + "
                         "batched recompute, the default) or 'ref' (the "
                         "historical oracle); results are bit-for-bit "
                         "identical")
    ap.add_argument("--lane-batch", type=int, default=None, metavar="N",
                    help="restart lanes the vec engine stacks per batched-"
                         "recompute dispatch (default: REPRO_LANE_BATCH env "
                         "or 64); results are identical at any value")
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()

    known = app_names()
    if args.app not in known:
        ap.error(f"unknown app {args.app!r}; registered apps: "
                 + ", ".join(sorted(known)))

    kw = dict(CI_SIZES.get(args.app, {}), n_iters=args.iters, device=args.device)
    if args.app in ("lm-train", "decode"):
        kw["base"] = get_arch(args.arch)
    app = get_app(args.app, **kw)
    fault = get_fault_model(args.fault_model, app=app)
    state = app.init(0)
    ws_blocks = sum(v.nbytes // 64 for v in state.values())
    cache = CacheConfig(capacity_blocks=max(8, int(ws_blocks * 0.5)))
    print(f"app={args.app} candidates={app.candidates}; "
          f"cache={cache.capacity_blocks} blocks of {ws_blocks}; "
          f"fault model: {fault.spec()}")

    base = CrashTester(
        app, PersistPlan.none(), cache, seed=0, fault=fault, engine=args.engine,
        lane_batch=args.lane_batch,
    ).run_campaign(args.tests, n_workers=args.workers, store_path=args.store)
    print(f"\nbaseline (no persistence): {base.class_fractions()}")
    print("per-object inconsistency -> recompute correlation (paper §5.1):")
    objs = [c for c in app.candidates if c != app.iterator_object]
    critical = []
    for s in select_objects(base, objs):
        flag = " <- critical" if s.critical else ""
        if s.critical:
            critical.append(s.name)
        print(f"  {s.name:8s} Rs={s.rs:+.3f} p={s.p_value:.1e}{flag}")
    mean_inc = {
        o: float(np.mean([r.inconsistency.get(o, 0) for r in base.records]))
        for o in objs
    }
    print("mean inconsistency rates:", {k: round(v, 3) for k, v in mean_inc.items()})

    persist = tuple(critical) or (objs[0],)
    ec = CrashTester(app, PersistPlan.at_loop_end(persist, app), cache,
                     seed=0, fault=fault, engine=args.engine,
                     lane_batch=args.lane_batch).run_campaign(
                         args.tests, n_workers=args.workers)
    print(f"\npersist {persist} at loop end: {ec.class_fractions()}")
    print(f"recomputability {base.recomputability:.0%} -> {ec.recomputability:.0%}")
    if args.app == "lm-train":
        print("\ntakeaway: SGD/Adam training is a naturally-resilient iterative "
              "method (paper §2.2) — block-stale parameters act as a bounded "
              "perturbation the optimizer absorbs; moments re-warm in a few steps.")


if __name__ == "__main__":
    main()
