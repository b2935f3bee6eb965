"""LM training under failures, both halves of the story, on the PyTorch port
(the card by default; ``--device cpu`` for the host):

1. *Characterize*: run the paper's crash-campaign workflow on
   :class:`repro_torch.models.train_app.LMTrainApp` (Adam on a reduced
   transformer) — S1–S4 rates, critical-object selection (params critical,
   moments re-warm), a knapsack persist plan, and a fingerprinted plan
   artifact.
2. *Produce*: drive the production trainer (``repro_torch.launch.train``) for a
   few hundred steps with injected failures, recovering via the EasyCrash
   arena (delta-snapshot persistence) with checkpoint fallback.  Watch the
   [restore] lines: recoveries come from the arena (fast path, M''), the
   loss curve continues where it left off.

Usage:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--tests 20]
                                                        [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import WorkflowConfig, run_workflow, save_plan
from repro_torch.hpc.suite import ci_app, default_cache
from repro_torch.launch.train import main as train_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tests", type=int, default=20)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_example_train"))
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()

    # ---- 1. campaign characterization of the training loop -----------------
    app = ci_app("lm-train", device=args.device)
    cache = default_cache(app)
    print(f"characterizing lm-train: {app.n_iters} Adam steps, "
          f"{app.init(0)['params'].size:,} params (reduced)")
    wf = run_workflow(app, WorkflowConfig(n_tests=args.tests, cache=cache, seed=0))
    print(f"S1-S4 (no persistence): {wf.baseline_campaign.class_fractions()}")
    for s in wf.object_scores:
        flag = " <- critical" if s.critical else ""
        print(f"  {s.name:8s} Rs={s.rs:+.3f} p={s.p_value:.1e}{flag}")
    print(f"plan: flush {wf.critical} at regions "
          f"{dict(sorted(wf.plan.region_freq.items()))}; recomputability "
          f"{wf.baseline_campaign.recomputability:.0%} -> "
          f"{wf.best_campaign.recomputability:.0%} (best)")
    plan_path = os.path.join(tempfile.mkdtemp(prefix="easycrash-"),
                             "lm-train.plan.json")
    fp = save_plan(plan_path, wf.plan, app_name=app.name, cache=cache,
                   meta={"tau": wf.tau, "t_s": wf.t_s})
    print(f"plan artifact: {plan_path} (sha256 {fp[:16]}...)")

    # ---- 2. production: injected failures, arena recovery ------------------
    print("\nproduction trainer: delta persistence + failure every 60 steps")
    shutil.rmtree(args.workdir, ignore_errors=True)
    train_main([
        "--arch", "stablelm-1.6b",
        "--width", "128",
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", "64",
        "--workdir", args.workdir,
        "--inject-failure-every", "60",
        "--flush-every", "1",
        "--persist-mode", "delta",
        "--mtbf", "120",
        "--t-chk", "2.0",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
