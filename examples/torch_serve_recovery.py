"""Decode serving under failures, both halves of the story, on the PyTorch
port (the card by default, where the prefill runs the flash-attention kernel
and every delta flush the delta-snapshot kernel; ``--device cpu`` for the
host):

1. *Characterize*: run the paper's crash-campaign workflow on
   :class:`repro_torch.models.serve_app.DecodeApp` — the decode loop as an
   IterativeApp — to measure S1–S4 rates, find which decode state is
   critical (the KV/recurrent cache *is* the session), and ship the
   resulting persist plan as a fingerprinted artifact.
2. *Produce*: drive the production server (``repro_torch.launch.serve``) with
   delta-snapshot persistence, kill it mid-stream, and resume sessions
   without re-running prefill.
3. *Project*: feed the campaign-measured recovery profile and persist
   overhead into the fleet simulator (``repro_torch.core.fleetsim``) — what the
   measured decode loop means for goodput, SLO, and p99 across a replica
   fleet failing at paper-like rates.

Usage:  PYTHONPATH=src python examples/torch_serve_recovery.py [--tests 16]
                                                              [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (
    POLICIES,
    ArrivalProcess,
    FleetConfig,
    PoissonTrace,
    RecomputeProfile,
    ServiceModel,
    SystemConfig,
    WorkflowConfig,
    fleet_frontier,
    run_workflow,
    save_plan,
)
from repro_torch.hpc.suite import ci_app, default_cache
from repro_torch.launch.serve import main as serve_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()

    # ---- 1. campaign characterization of the decode loop -------------------
    app = ci_app("decode", device=args.device)
    cache = default_cache(app)
    print(f"characterizing decode: batch={app.batch} prompt_len={app.prompt_len} "
          f"steps={app.n_iters} (acceptance: token match >= {app.match_frac})")
    wf = run_workflow(app, WorkflowConfig(n_tests=args.tests, cache=cache, seed=0))
    print(f"S1-S4 (no persistence): {wf.baseline_campaign.class_fractions()}")
    print(f"critical decode state: {wf.critical}")
    print(f"plan: flush at regions {dict(sorted(wf.plan.region_freq.items()))}; "
          f"recomputability {wf.baseline_campaign.recomputability:.0%} -> "
          f"{wf.best_campaign.recomputability:.0%} (best)")
    plan_path = os.path.join(tempfile.mkdtemp(prefix="easycrash-"),
                             "decode.plan.json")
    fp = save_plan(plan_path, wf.plan, app_name=app.name, cache=cache,
                   meta={"tau": wf.tau, "t_s": wf.t_s})
    print(f"plan artifact: {plan_path} (sha256 {fp[:16]}...)")

    # ---- 2. production: delta-persisted decode, killed and resumed ---------
    print("\nproduction server: delta persistence + mid-stream kill/resume")
    workdir = os.path.join(tempfile.gettempdir(), "repro_torch_example_serve")
    shutil.rmtree(workdir, ignore_errors=True)
    serve_main([
        "--arch", "stablelm-1.6b",
        "--width", "128",
        "--prompts", "4",
        "--prompt-len", "32",
        "--decode-steps", "48",
        "--flush-every", "4",
        "--persist-mode", "delta",
        "--workdir", workdir,
        "--inject-failure-at", "24",
        "--device", args.device,
    ])

    # ---- 3. fleet projection: the measured profile at serving scale --------
    print("\nfleet projection: measured decode profile across 4 replicas")
    profile = RecomputeProfile.from_campaign(wf.best_campaign)
    cfg = FleetConfig(
        n_replicas=4,
        arrival=ArrivalProcess(rate=5.0, amplitude=0.3),
        service=ServiceModel(mean_s=0.5, sigma=0.6, prefill_s=1.5),
        trace=PoissonTrace(mtbf=900.0),
        system=SystemConfig(mtbf=900.0, t_chk=30.0, nvm_restore_time=2.0),
        slo_latency=2.0,
        queue_cap=48,
        horizon=1800.0,
        t_s=wf.t_s,
        seed=0,
    )
    doc = fleet_frontier(cfg, profile)
    print(f"  profile S1-S4: {dict(profile.fractions)} (persist tax "
          f"t_s={wf.t_s:.3f})")
    for policy in POLICIES:
        p = doc["policies"][policy]
        print(f"  {policy:10s} goodput={p['goodput']:.3f}rps "
              f"slo={p['slo_violation_frac']:.3f} "
              f"p99={p['latency_p99']:.2f}s fails={p['n_failures']}")


if __name__ == "__main__":
    main()
