"""The full EasyCrash workflow (paper §5.3) on the shared-pool orchestrator,
on the PyTorch port (the card by default; ``--device cpu`` for the host).

One command runs characterize -> select objects -> measure regions -> solve
the knapsack, with every campaign's crash-test shards interleaved on a single
process pool.  The run is killable: with ``--workflow-store`` every completed
shard is durably appended to a JSONL WorkflowStore, and re-running the same
command resumes, executing only the missing shards (results are bit-for-bit
identical to an uninterrupted run, for any worker count).

``--artifact`` writes the product of the workflow — the persist plan plus
selection evidence — as a fingerprinted JSON artifact that
``repro_torch.core.artifacts.replay_plan`` can re-characterize under any fault
model (the JAX package's ``benchmarks/bench_recomputability.py
--robustness-matrix`` does so).

``--kill-after-shards N`` hard-kills the process (``os._exit(137)``) after N
shards have been durably stored — a deterministic stand-in for `kill -9`,
used by the CI resume smoke test.

Usage:  PYTHONPATH=src python examples/torch_workflow_orchestrate.py \
            [--app sor] [--tests 40] [--workers 4] \
            [--workflow-store wf.jsonl] [--artifact plan.json] \
            [--fault-model torn-write] [--region-measure isolated] \
            [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    from repro_torch.core.artifacts import (
        load_workflow,
        save_plan,
        save_profile,
        save_workflow,
    )
    from repro_torch.core.cache_sim import ENGINES
    from repro_torch.core.campaign_store import WorkflowStore
    from repro_torch.core.faults import FAULT_MODELS, get_fault_model
    from repro_torch.core.workflow import WorkflowConfig, run_workflow
    from repro_torch.hpc.suite import CI_SIZES, ci_app, default_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="sor", choices=sorted(CI_SIZES))
    ap.add_argument("--tests", type=int, default=40)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--region-measure", default="isolated",
                    choices=("isolated", "paper"))
    ap.add_argument("--fault-model", default="power-fail",
                    choices=sorted(FAULT_MODELS))
    ap.add_argument("--workflow-store", default=None, metavar="PATH",
                    help="JSONL WorkflowStore; an interrupted workflow "
                         "resumes from it, executing only missing shards")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="write the workflow summary (PATH) and persist plan "
                         "(PATH stem + '.plan.json') as fingerprinted JSON")
    ap.add_argument("--kill-after-shards", type=int, default=0, metavar="N",
                    help="os._exit(137) after N durably stored shards "
                         "(simulated kill -9; requires --workflow-store)")
    ap.add_argument("--engine", default=None, choices=list(ENGINES),
                    help="campaign hot path (default vec); bit-for-bit "
                         "identical results either way")
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()
    if args.kill_after_shards and not args.workflow_store:
        ap.error("--kill-after-shards requires --workflow-store (the kill "
                 "fires from the store's shard callback)")

    app = ci_app(args.app, device=args.device)
    cache = default_cache(app)
    fault = get_fault_model(args.fault_model, app=app)

    stored = 0
    if args.workflow_store and os.path.exists(args.workflow_store):
        by_campaign = WorkflowStore(args.workflow_store).completed_shards_by_campaign()
        stored = sum(len(shards) for shards in by_campaign.values())
        print(f"resuming: {stored} shards already in {args.workflow_store}")

    executed = []

    def on_shard(key: str, shard_id: int) -> None:
        executed.append((key, shard_id))
        if args.kill_after_shards and len(executed) >= args.kill_after_shards:
            print(f"[kill] simulated power failure after "
                  f"{len(executed)} shards (last: {key}:{shard_id})")
            sys.stdout.flush()
            os._exit(137)

    wf = run_workflow(app, WorkflowConfig(
        n_tests=args.tests, cache=cache, seed=0,
        region_measure=args.region_measure, n_workers=args.workers,
        fault_model=fault, store_path=args.workflow_store,
        shard_callback=on_shard if args.workflow_store else None,
        engine=args.engine,
    ))

    print(f"\napp={args.app} fault={fault.spec()} workers={args.workers}")
    print(f"shards: {len(executed)} executed this run"
          + (f", {stored} resumed from store" if args.workflow_store else ""))
    print(f"critical objects: {wf.critical}")
    print(f"plan: flush at regions "
          f"{dict(sorted(wf.plan.region_freq.items()))} (region: every-x-iters)")
    for k, v in wf.summary().items():
        print(f"  {k:28s} {v:.4f}")

    if args.artifact:
        fp = save_workflow(args.artifact, wf, fault=fault, cache=cache)
        plan_path = os.path.splitext(args.artifact)[0] + ".plan.json"
        save_plan(plan_path, wf.plan, app_name=app.name, fault=fault,
                  cache=cache,
                  meta={"tau": wf.tau, "t_s": wf.t_s,
                        "expected_recomputability":
                            wf.region_selection.expected_recomputability})
        # the measured S1-S4 rates + recompute-cost histogram, for the
        # system-efficiency simulator (examples/torch_system_efficiency.py)
        profile_path = os.path.splitext(args.artifact)[0] + ".profile.json"
        save_profile(profile_path, wf.recompute_profile(fault=fault),
                     meta={"campaign": "best", "n_tests": args.tests})
        check = load_workflow(args.artifact)  # verifies the fingerprint
        assert check.plan == wf.plan
        print(f"artifacts: {args.artifact} (fingerprint {fp[:16]}...) "
              f"+ {plan_path} + {profile_path}")


if __name__ == "__main__":
    main()
