"""Quickstart: EasyCrash on a conjugate-gradient solver in ~60 lines, on the
PyTorch port (the card by default; ``--device cpu`` for the host).

Runs the full paper pipeline on one app:
  1. golden run + acceptance verification
  2. crash-test campaign without persistence (intrinsic recomputability)
  3. Spearman object selection + knapsack region selection
  4. validation campaign with the selected plan
  5. system-efficiency projection at 100k-node scale
  6. ship the plan as a fingerprinted artifact and replay it from disk

Usage:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import CrashTester, SystemConfig, efficiency_with, efficiency_without
from repro_torch.core.artifacts import load_plan, save_plan
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import ci_app, default_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()

    app = ci_app("cg", device=args.device)
    cache = default_cache(app)
    print(f"app={app.name} grid={app.grid} cache={cache.capacity_blocks} blocks")

    # golden run
    state, iters = app.run_golden()
    res = app.verify(state)
    print(f"golden: {iters} iterations, residual={res.metric:.2e}, verified={res.passed}")

    # steps 1-3: characterize, select objects, select regions
    wf = run_workflow(app, WorkflowConfig(n_tests=60, cache=cache, seed=0))
    print("\nSpearman object selection (paper §5.1):")
    for s in wf.object_scores:
        flag = " <- critical" if s.critical else ""
        print(f"  {s.name:10s} Rs={s.rs:+.3f} p={s.p_value:.1e}{flag}")
    print(f"\nknapsack plan (paper §5.2): flush {wf.critical} at regions "
          f"{dict(wf.plan.region_freq)} (region:every-x-iters)")
    print(f"predicted overhead {100*wf.region_selection.total_overhead:.2f}% "
          f"<= t_s={100*wf.t_s:.0f}%; tau={wf.tau:.2f}")

    # step 4: validate
    val = CrashTester(app, wf.plan, cache, seed=99).run_campaign(60)
    print(f"\nrecomputability: baseline {wf.baseline_campaign.recomputability:.0%} "
          f"-> EasyCrash {val.recomputability:.0%} "
          f"(best achievable {wf.best_campaign.recomputability:.0%})")
    print("outcome classes with EasyCrash:", val.class_fractions())

    # what it buys a 100k-node system
    cfg = SystemConfig(mtbf=12 * 3600.0, t_chk=3200.0)
    base = efficiency_without(cfg).efficiency
    ec = efficiency_with(cfg, val.recomputability, t_s=wf.region_selection.total_overhead).efficiency
    print(f"\n100k-node projection (MTBF 12h, T_chk 3200s): "
          f"efficiency {base:.1%} -> {ec:.1%} (+{100*(ec-base):.1f} pts)")

    # step 4 product: the plan travels as a fingerprinted JSON artifact
    # (repro_torch.core.artifacts); production loads it, verification included
    plan_path = os.path.join(tempfile.mkdtemp(prefix="easycrash-"), "cg.plan.json")
    fp = save_plan(plan_path, wf.plan, app_name=app.name, cache=cache,
                   meta={"tau": wf.tau, "t_s": wf.t_s})
    art = load_plan(plan_path)  # raises ArtifactError if tampered/truncated
    assert art.plan == wf.plan
    print(f"plan artifact: {plan_path} (sha256 {fp[:16]}..., "
          f"fault={art.fault_spec['model']})")


if __name__ == "__main__":
    main()
