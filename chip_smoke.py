#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel of the path (``nvcc`` for sm_90a, from
   ``src/repro_torch/kernels/csrc``);
2. each kernel against its plain PyTorch version on the card, exactly, then
   both timed with CUDA events at the main path's shape beside the bound;
3. characterization: the sor crash campaign reproduces its pinned golden
   (``tests/golden/campaign_goldens.json``) on the card, and ``run_workflow``
   gives the plan the JAX package gives;
4. deployment: SOR at grid 8192 (u, res and b are 256 MiB each in float32)
   runs under ``EasyCrashManager`` with that plan and delta flushes whose
   masks come from the ``delta_snapshot`` kernel; then a crash, a restore
   from the NVM arena, and more iterations from the restored state, each
   flushed again through the kernel against the shadow the restore left.

The second line from the end is a JSON object with one entry per kernel,
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script prints no result and exits with 2; outside the repository it cannot
import the port and exits with 1.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.convert import state_to_torch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CrashTester,
    EasyCrashManager,
    FlushPolicy,
    NVMArena,
    PersistPlan,
    WorkflowConfig,
    run_workflow,
)
from repro_torch.hpc.common import laplacian_apply  # noqa: E402
from repro_torch.hpc.sor import SORApp, _rb_sor  # noqa: E402
from repro_torch.hpc.suite import ci_app, default_cache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.delta_snapshot import dirty_block_mask  # noqa: E402
from repro_torch.kernels.delta_snapshot.ref import dirty_block_mask_reference  # noqa: E402

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: the deployment's grid: u is 8192^2 float32 = 256 MiB
DEPLOY_GRID = 8192
DEPLOY_ITERS = 16
AFTER_RESTORE_ITERS = 4
BLOCK_BYTES = 64
GOLDENS = os.path.join(ROOT, "tests", "golden", "campaign_goldens.json")
#: the plan the JAX package's run_workflow gives for ci_app("sor"),
#: WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)
JAX_SOR_PLAN = (("u",), {1: 4, 2: 1})


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def delta_bound_ms(nbytes: int, block_bytes: int) -> float:
    """Least time for the mask: both inputs read once, the int32 mask
    written once, at the device-memory rate."""
    n_blocks = -(-nbytes // block_bytes)
    return (2 * nbytes + 4 * n_blocks) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------- 1. environment
def phase_environment() -> str:
    gpu = gpu_name_and_power()
    log(f"[env] gpu: {gpu}")
    log(f"[env] torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build("delta_snapshot")
    log(f"[env] built {', '.join(os.path.relpath(str(p), ROOT) for p in paths.values())} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[env] ptxas {name}: {line.strip()}")
    return gpu


# --------------------------------------------- 2. kernel against plain version
def _kernel_cases(dev: str):
    """(label, x, prev, block_elems): sparse random dirt, an all-clean pair,
    planted float specials, and an unaligned view (the scalar kernel)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (0, 1, 63, 64, 65, 4097, (256 << 20) + 3):
        x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
        p = x.clone()
        if n:
            idx = torch.randint(0, n, (max(1, n // 1000),), generator=gen, device=dev)
            p[idx] += 1
        yield f"uint8 n={n} sparse", x, p, 64
        yield f"uint8 n={n} clean", x, x.clone(), 64
    base = torch.randint(0, 256, (4098,), generator=gen, device=dev, dtype=torch.uint8)
    other = base.clone()
    other[[7, 2000, 4097]] += 1
    yield "uint8 n=4097 unaligned view", base[1:], other[1:], 64
    for n in (1, 255, 256, 257, 4097, 1 << 20):
        x = torch.randn(n, generator=gen, device=dev)
        p = x.clone()
        idx = torch.randint(0, n, (max(1, n // 1000),), generator=gen, device=dev)
        p[idx] += 1.0
        if n >= 1024:
            x[3] = float("nan")                        # NaN vs a number: dirty
            x[300] = p[300] = float("nan")             # NaN vs NaN: dirty
            x[600], p[600] = -0.0, 0.0                 # -0 vs +0: clean
        yield f"float32 n={n} sparse+specials", x, p, 256
        yield f"float32 n={n} clean", x, x.clone(), 256


def check_kernel(dev: str) -> int:
    """Every case exactly equal to the plain version; returns the largest
    absolute difference of the masks (0)."""
    max_err = 0
    n_cases = 0
    for label, x, p, be in _kernel_cases(dev):
        got = dirty_block_mask(x, p, block_elems=be)
        torch.cuda.synchronize()
        want = dirty_block_mask_reference(x, p, be)
        # a clean pair has no dirt, unless it holds NaN (never equal to itself)
        has_nan = x.is_floating_point() and bool(torch.isnan(x).any())
        if "clean" in label and not has_nan and bool(want.any()):
            raise AssertionError(f"{label}: the plain version reports dirt in a clean pair")
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: kernel gave {got.shape}/{got.dtype}, "
                                 f"plain {want.shape}/{want.dtype}")
        err = int((got - want).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel mask differs from the plain version "
                                 f"in {int((got != want).sum())} blocks")
        max_err = max(max_err, err)
        n_cases += 1
    log(f"[kernel] delta_snapshot equals its plain version exactly in {n_cases} cases")
    return max_err


def time_kernel(dev: str) -> dict:
    nbytes = DEPLOY_GRID * DEPLOY_GRID * 4
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (nbytes,), generator=gen, device=dev, dtype=torch.uint8)
    p = x.clone()
    p[torch.randint(0, nbytes, (nbytes // 4096,), generator=gen, device=dev)] += 1
    ms = cuda_ms(lambda: dirty_block_mask(x, p, block_elems=BLOCK_BYTES))
    plain_ms = cuda_ms(lambda: dirty_block_mask_reference(x, p, BLOCK_BYTES))
    bound = delta_bound_ms(nbytes, BLOCK_BYTES)
    log(f"[kernel] delta_snapshot at {nbytes} bytes, {BLOCK_BYTES}-byte blocks: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({bound / ms:.1%} of the bound)")
    del x, p
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}


# ------------------------------------------------------------ 3. characterize
def phase_characterize(dev: str) -> PersistPlan:
    with open(GOLDENS) as f:
        goldens = json.load(f)
    cfg = goldens["config"]
    want = goldens["apps"]["sor"]
    app = ci_app("sor", device=dev)
    t0 = time.perf_counter()
    camp = CrashTester(app, PersistPlan.none(), default_cache(app),
                       seed=cfg["seed"]).run_campaign(cfg["n_tests"])
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    got = {"counts": counts, "golden_iters": camp.golden_iters,
           "crash_iters": [r.iter_idx for r in camp.records]}
    log(f"[characterize] sor campaign on {dev}: {got} in {time.perf_counter() - t0:.1f} s")
    if got != want:
        raise AssertionError(f"sor campaign differs from its golden {want}")

    t0 = time.perf_counter()
    wf = run_workflow(app, WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0))
    plan = wf.plan
    log(f"[characterize] run_workflow plan: {plan} in {time.perf_counter() - t0:.1f} s")
    if (plan.objects, plan.region_freq) != JAX_SOR_PLAN:
        raise AssertionError(f"plan differs from the JAX plan {JAX_SOR_PLAN}")

    # information only: one sweep pair on the card against the same on the CPU
    rng = np.random.default_rng(0)
    u = rng.standard_normal(app.grid ** 2).astype(np.float32)
    b = app.init(0)["b"]
    on_cpu = _rb_sor(torch.from_numpy(u), torch.from_numpy(b), app.grid, app.omega, 1)
    on_dev = _rb_sor(torch.from_numpy(u).to(dev), torch.from_numpy(b).to(dev),
                     app.grid, app.omega, 1).cpu()
    log(f"[characterize] one sweep pair, card vs CPU: max |diff| "
        f"{float((on_dev - on_cpu).abs().max()):.3e}, bitwise {torch.equal(on_dev, on_cpu)}")
    return plan


# ------------------------------------------------------------------ 4. deploy
def _energy(u: torch.Tensor, b: torch.Tensor, g: int) -> float:
    """E(u) = u'Au/2 - b'u in float64.  SOR with 0 < omega < 2 lowers it at
    every half sweep (it is the error's A-norm up to a constant); the
    residual norm is not monotone while the iteration is young."""
    u64, b64 = u.double(), b.double()
    return float(0.5 * torch.dot(u64, laplacian_apply(u64, g)) - torch.dot(b64, u64))


def _same_bytes(img: np.ndarray, live: torch.Tensor) -> bool:
    dev_img = torch.from_numpy(np.ascontiguousarray(img)).to(live.device)
    return (dev_img.shape == live.shape and dev_img.dtype == live.dtype
            and torch.equal(dev_img.view(torch.uint8), live.view(torch.uint8)))


def phase_deploy(dev: str, plan: PersistPlan) -> dict:
    app = SORApp(grid=DEPLOY_GRID, device=dev)
    g = app.grid
    t0 = time.perf_counter()
    state = state_to_torch(app.init(0), dev)
    log(f"[deploy] SOR grid {g}: u {state['u'].numel() * 4} bytes on {dev}, "
        f"init {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arena = NVMArena(BLOCK_BYTES)
    policy = FlushPolicy(leaves=plan.objects, every_steps=min(plan.region_freq.values()),
                         async_flush=False, persist_mode="delta")
    mgr = EasyCrashManager(arena, policy)

    iter_s, flush_s = [], []
    steady = None  # manager stats after the first (full-write) flush
    prev_u = None
    for step in range(1, DEPLOY_ITERS + 1):
        t0 = time.perf_counter()
        state = app.run_iteration(state)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        expect = None
        if prev_u is not None:  # spot check: the plain version's count of dirty blocks
            ref = dirty_block_mask_reference(state["u"].view(torch.uint8),
                                             prev_u.view(torch.uint8), BLOCK_BYTES)
            expect = int(ref.sum()) + 1  # + the __step__ leaf's one block
        before = mgr.stats.blocks_written
        t0 = time.perf_counter()
        if not mgr.maybe_flush(step, state):
            raise AssertionError(f"step {step}: the plan's cadence flushes every step")
        flush_s.append(time.perf_counter() - t0)
        written = mgr.stats.blocks_written - before
        if expect is not None and written != expect:
            raise AssertionError(f"step {step}: flush wrote {written} blocks, "
                                 f"the plain mask says {expect}")
        for name in plan.objects:
            if not _same_bytes(arena.peek(name), state[name]):
                raise AssertionError(f"step {step}: arena image of {name!r} != live bytes")
        if int(arena.get("__step__")) != step:
            raise AssertionError(f"step {step}: arena step is {int(arena.get('__step__'))}")
        if step == 1:
            steady = dict(vars(mgr.stats))
        prev_u = state["u"].clone()
    peak = torch.cuda.max_memory_allocated()
    n_steady = DEPLOY_ITERS - 1
    st = vars(mgr.stats)
    split = {k: (st[k] - steady[k]) / n_steady * 1e3
             for k in ("mask_seconds", "copy_seconds", "arena_seconds")}
    out = {
        "ms_per_iter": float(np.mean(iter_s)) * 1e3,
        "ms_first_flush": flush_s[0] * 1e3,
        "ms_per_flush": float(np.mean(flush_s[1:])) * 1e3,
        "flush_split_ms": split,
        "bytes_written": mgr.stats.bytes_written,
        "bytes_per_flush": (st["bytes_written"] - steady["bytes_written"]) / n_steady,
        "peak_device_bytes": peak,
    }
    log(f"[deploy] {DEPLOY_ITERS} iterations: {out['ms_per_iter']:.2f} ms/iteration, "
        f"first flush (full write) {out['ms_first_flush']:.1f} ms, then "
        f"{out['ms_per_flush']:.1f} ms/flush (mask {split['mask_seconds']:.1f}, "
        f"device-to-host {split['copy_seconds']:.1f}, arena {split['arena_seconds']:.1f} ms)")
    log(f"[deploy] bytes written {out['bytes_written']} "
        f"({out['bytes_per_flush']:.0f} per delta flush), peak device memory {peak} bytes")

    # crash: the live state is gone; a new manager restores from the arena
    last_step, last_u = DEPLOY_ITERS, prev_u
    del state
    mgr.close()
    fresh = state_to_torch(app.init(0), dev)
    e_fresh = _energy(fresh["u"], fresh["b"], g)
    mgr = EasyCrashManager(arena, policy)
    restored, step, source = mgr.restore(
        fresh, verify=lambda s, k: _energy(s["u"], s["b"], g) < e_fresh
    )
    if source != "easycrash" or step != last_step:
        raise AssertionError(f"restore gave source={source!r} step={step}")
    if restored["u"].device != last_u.device or not torch.equal(
            restored["u"].view(torch.uint8), last_u.view(torch.uint8)):
        raise AssertionError("restored u differs from the last flushed bytes")
    energies = [_energy(restored["u"], restored["b"], g)]
    residuals = [app.progress(restored)]
    state = restored
    for k in range(1, AFTER_RESTORE_ITERS + 1):
        state = app.run_iteration(state)
        energies.append(_energy(state["u"], state["b"], g))
        residuals.append(app.progress(state))
        # the restarted run flushes on: the restore left the manager a shadow
        # of u on the card, so this delta mask comes from the kernel as well
        launches = dirty_block_mask.launches
        if not mgr.maybe_flush(last_step + k, state):
            raise AssertionError(f"step {last_step + k}: no flush after the restore")
        if dirty_block_mask.launches != launches + len(plan.objects):
            raise AssertionError(f"step {last_step + k}: the flush after the restore "
                                 f"did not launch delta_snapshot")
        for name in plan.objects:
            if not _same_bytes(arena.peek(name), state[name]):
                raise AssertionError(f"step {last_step + k}: arena image of {name!r} "
                                     f"!= live bytes")
    if not all(b < a for a, b in zip(energies, energies[1:])):
        raise AssertionError(f"energy did not fall after the restore: {energies}")
    log(f"[deploy] restored step {step} from the arena (source={source}); "
        f"{AFTER_RESTORE_ITERS} more iterations, each flushed through the kernel: "
        f"energy {energies}, relative residual {residuals}")
    mgr.close()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    dev = "cuda"
    gpu = phase_environment()
    max_err = check_kernel(dev)
    kern = time_kernel(dev)

    dirty_block_mask.launches = 0
    plan = phase_characterize(dev)
    deploy = phase_deploy(dev, plan)
    launches = dirty_block_mask.launches
    want = (DEPLOY_ITERS - 1 + AFTER_RESTORE_ITERS) * len(plan.objects)
    if launches != want:
        raise AssertionError(f"delta_snapshot launched {launches} times on the main path, "
                             f"expected one per leaf and delta flush ({want})")
    log(f"[deploy] summary {json.dumps(deploy)}")

    log(gpu)
    print(json.dumps({"kernels": [{
        "name": "delta_snapshot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_snapshot.cu",
        "replaces": "src/repro/kernels/delta_snapshot/kernel.py:26",
        "launches": launches,
        "max_abs_err": max_err,
        "exact": max_err == 0,
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
