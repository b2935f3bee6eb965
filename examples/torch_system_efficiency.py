"""The paper's closing figure, reproduced from stored artifacts: hybrid
checkpoint+EasyCrash vs checkpoint-only system efficiency, on the PyTorch
port (a campaign it measures runs on the card by default; ``--device cpu``
for the host).

The input is the product of a finished characterization run — either

* a **recompute-profile artifact** (``--profile``), written by
  ``examples/torch_workflow_orchestrate.py --artifact`` or
  ``repro_torch.core.artifacts.save_profile``: campaign-measured S1–S4 rates plus
  the extra-recompute-iteration histogram; or
* a **workflow artifact** (``--workflow``): the S1–S4 fractions of its
  persist-everywhere campaign (no cost histogram — S2 recoveries are then
  priced at the NVM restore cost alone); or
* nothing: a small campaign is run on ``--app`` first, so the example is
  self-contained (``--save-profile`` keeps the measured profile).

For each checkpoint cost the script prints the analytic closed forms
(Eqs. 6–9) next to the discrete-event simulation of the four policies under
a Poisson failure trace — the "up to 24 %, 15 % on average" comparison, with
measured rates instead of an assumed recomputability.

Usage:  PYTHONPATH=src python examples/torch_system_efficiency.py \
            [--profile prof.json | --workflow wf.json] [--app sor]
            [--tests 40] [--failures 4000] [--mtbf-hours 12]
            [--save-profile out.json] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    from repro_torch.core import (
        CrashTester,
        PersistPlan,
        PoissonTrace,
        RecomputeProfile,
        SystemConfig,
        efficiency_with,
        efficiency_without,
        load_profile,
        load_workflow,
        profile_from_workflow,
        save_profile,
        simulate_policy,
    )
    from repro_torch.hpc.suite import CI_SIZES, ci_app, default_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="recompute-profile artifact to drive the simulator")
    ap.add_argument("--workflow", default=None, metavar="PATH",
                    help="workflow artifact (rates of its 'best' campaign)")
    ap.add_argument("--app", default="sor", choices=sorted(CI_SIZES),
                    help="app to measure when no artifact is given")
    ap.add_argument("--tests", type=int, default=40,
                    help="campaign size when measuring in-process")
    ap.add_argument("--failures", type=int, default=4000,
                    help="failure events per simulated point")
    ap.add_argument("--mtbf-hours", type=float, default=12.0)
    ap.add_argument("--t-s", type=float, default=0.015,
                    help="EasyCrash flush-overhead fraction")
    ap.add_argument("--save-profile", default=None, metavar="PATH",
                    help="write the measured profile as a fingerprinted artifact")
    ap.add_argument("--device", default="cuda",
                    help="where the apps run: cuda (default) or cpu")
    args = ap.parse_args()
    if args.profile and args.workflow:
        ap.error("--profile and --workflow are mutually exclusive")

    if args.profile:
        art = load_profile(args.profile)
        prof = art.profile
        print(f"profile artifact: {args.profile} "
              f"(app={prof.app_name}, fingerprint {art.fingerprint[:16]}...)")
    elif args.workflow:
        wa = load_workflow(args.workflow)
        prof = profile_from_workflow(wa, which="best")
        print(f"workflow artifact: {args.workflow} (app={wa.app_name}; "
              f"no recompute-cost histogram — S2 priced at NVM restore only)")
    else:
        app = ci_app(args.app, device=args.device)
        cache = default_cache(app)
        plan = PersistPlan.at_loop_end(app.candidates, app)
        print(f"measuring: {args.tests}-test campaign on {args.app} "
              f"(flush {plan.objects} at loop end)...")
        camp = CrashTester(app, plan, cache, seed=0).run_campaign(args.tests)
        prof = RecomputeProfile.from_campaign(camp)

    print(f"rates: S1={prof.fractions.get('S1', 0.0):.2f} "
          f"S2={prof.fractions.get('S2', 0.0):.2f} "
          f"S3={prof.fractions.get('S3', 0.0):.2f} "
          f"S4={prof.fractions.get('S4', 0.0):.2f}  "
          f"(success {prof.success_rate:.2f}, "
          f"mean S2 recompute {prof.mean_extra_iters():.1f} iters)")
    if args.save_profile:
        fp = save_profile(args.save_profile, prof,
                          meta={"source": "system_efficiency example"})
        print(f"profile artifact -> {args.save_profile} "
              f"(fingerprint {fp[:16]}...)")

    mtbf = args.mtbf_hours * 3600.0
    print(f"\nmtbf={args.mtbf_hours:g} h, t_s={args.t_s:g}, "
          f"{args.failures} failure events per point (seeded)")
    header = (f"{'t_chk':>7} | {'analytic':^17} | "
              f"{'simulated (failure trace)':^37} | gain")
    print(header)
    print(f"{'':>7} | {'C/R':>7} {'EC+C/R':>8} | "
          f"{'none':>7} {'ckpt':>7} {'easycr':>7} {'hybrid':>7} "
          f"{'':>4} | hyb-ckpt")
    print("-" * len(header))
    gains = []
    for t_chk in (32.0, 320.0, 3200.0):
        cfg = SystemConfig(mtbf=mtbf, t_chk=t_chk)
        trace = PoissonTrace(cfg.mtbf)
        base = efficiency_without(cfg).efficiency
        ec = efficiency_with(cfg, prof.recomputability, t_s=args.t_s).efficiency
        sim = {
            policy: simulate_policy(policy, cfg, trace, prof,
                                    n_failures=args.failures,
                                    t_s=args.t_s, seed=7).efficiency
            for policy in ("none", "checkpoint", "easycrash", "hybrid")
        }
        gain = 100 * (sim["hybrid"] - sim["checkpoint"])
        gains.append(gain)
        print(f"{int(t_chk):>6}s | {base:>7.4f} {ec:>8.4f} | "
              f"{sim['none']:>7.4f} {sim['checkpoint']:>7.4f} "
              f"{sim['easycrash']:>7.4f} {sim['hybrid']:>7.4f}      | "
              f"{gain:+5.1f} pts")
    print(f"\nhybrid over checkpoint-only: up to {max(gains):.1f} pts, "
          f"{sum(gains) / len(gains):.1f} on average "
          f"(paper: up to 24, 15 on average)")


if __name__ == "__main__":
    main()
