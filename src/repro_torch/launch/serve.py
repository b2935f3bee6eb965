# Port of repro/launch/serve.py.  What differs:
# * --device (default cuda; raises without CUDA unless --device cpu).  On a
#   CUDA device the prefill runs the kernels (impl="kernel": flash
#   attention, rwkv6_scan, rglru_scan); on the CPU the reference path.
# * _splice_cache copies into the decode cache's own tensors (K/V prefixes,
#   and the recurrent state leaves whole), so the cache the manager flushes
#   is the one init_cache made.
# * Weights come from a torch.Generator seeded with --seed, the prompts from
#   one seeded with 7 (JAX's PRNGKey(seed) and PRNGKey(7) give other
#   numbers); run() also takes the weights and prompts from its caller.
# * The cache and a token buffer of the full (B, prompt + decode + 1)
#   width stay on the device, and the manager gets those tensors: there is
#   no per-step host copy (the manager copies at flush time).  JAX flushes
#   the growing concatenation of the tokens instead; here the tokens leaf
#   keeps one size, so its flushes are delta flushes too, and the positions
#   not decoded yet hold 0.  A resume restores through the manager, which
#   seeds its delta shadows on the device.
# * run() times prefill, decode and flushes (synchronizing the device) and
#   returns the token stream; on_flush lets a caller check each flush.
# * The default --workdir is build/repro_torch_serve in the repository.
# * main() returns the run's stats, and with --fleet the fleet document
#   fleet_report gives (the per-policy results) under "fleet".
"""Batched decode server with EasyCrash KV-cache persistence.

Serves a (reduced-by-default) architecture: prefill a batch of prompts,
decode greedily, and persist the decode cache incrementally so a crashed
server resumes sessions without re-running prefill.
``--inject-failure-at`` kills the server mid-stream to demonstrate the
recovery path: the restart reloads the cache and tokens from the arena and
continues.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --prompts 4 --decode-steps 64 --inject-failure-at 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device cpu

An MoE arch's prefill dispatches its tokens in ``dispatch_groups`` groups
(32 for both MoE archs), so --prompts x --prompt-len must be a multiple of
it.  On the card, ``--arch qwen2-moe-a2.7b --full-size`` serves
Qwen1.5-MoE-A2.7B whole (28.6 GB of bf16 weights).
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from ..configs import get_arch
from ..convert import host_array
from ..core.arena import NVMArena
from ..core.manager import EasyCrashManager, FlushPolicy
from ..device import resolve_device
from ..models import init_cache, init_params, scaled_down
from .steps import make_decode_fn, make_prefill_step

DEFAULT_WORKDIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_serve"


class SimulatedFailure(RuntimeError):
    pass


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)


def make_prompts(cfg, n: int, length: int, device: str, seed: int = 7) -> torch.Tensor:
    """(n, length) int32 prompt ids drawn from a generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (n, length), generator=gen, device=device,
                         dtype=torch.int32)


def run(args, params: Optional[Dict[str, Any]] = None, prompts: Optional[torch.Tensor] = None,
        on_flush: Optional[Callable[[int, Dict[str, Any], NVMArena], None]] = None
        ) -> Dict[str, Any]:
    """Serve once: prefill (or resume from the arena), decode, flush.

    ``params`` and ``prompts`` replace the seeded ones; ``on_flush(step,
    state, arena)`` runs after every flush.  Returns the stats, with the
    token stream (B, prompt + 1 + decode) under ``"tokens"``.
    """
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = scaled_down(cfg, width=args.width)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    impl = "kernel" if device.startswith("cuda") else "reference"
    prefill_fn = make_prefill_step(cfg, impl)
    decode_fn = make_decode_fn(cfg)

    os.makedirs(args.workdir, exist_ok=True)
    arena_dir = os.path.join(args.workdir, "serve_arena")
    try:
        arena = NVMArena.reattach(arena_dir)
        resumed = True
    except Exception:
        arena = NVMArena(backing_dir=arena_dir)
        resumed = False
    policy = FlushPolicy(leaves=("cache", "tokens"), every_steps=args.flush_every,
                         async_flush=False, persist_mode=args.persist_mode)
    mgr = EasyCrashManager(arena, policy)

    max_len = args.prompt_len + args.decode_steps + 1
    if prompts is None:
        prompts = make_prompts(cfg, args.prompts, args.prompt_len, device)
    prompts = prompts.to(device=device, dtype=torch.int32)
    p0 = args.prompt_len  # the first decoded token sits at p0
    tokens = torch.zeros((args.prompts, max_len), dtype=torch.int32, device=device)
    tokens[:, :p0] = prompts

    prefill_s = 0.0
    if resumed and "__step__" in arena:
        start = int(arena.get("__step__"))
        print(f"[restore] resuming decode at step {start} from arena")
        template = {"cache": init_cache(cfg, args.prompts, max_len, device), "tokens": tokens}
        state, _, source = mgr.restore(template)
        if source != "easycrash":
            raise RuntimeError(f"the arena at {arena_dir} did not restore (source {source!r})")
        cache, tokens = state["cache"], state["tokens"]
        token = tokens[:, p0 + start:p0 + start + 1]
    else:
        start = 0
        _sync(device)
        t0 = time.perf_counter()
        logits, pcache = prefill_fn(params, {"tokens": prompts})
        cache = _splice_cache(cfg, init_cache(cfg, args.prompts, max_len, device), pcache,
                              args.prompt_len)
        token = logits.argmax(dim=-1).to(torch.int32)[:, None]
        tokens[:, p0] = token[:, 0]
        _sync(device)
        prefill_s = time.perf_counter() - t0

    decode_s = flush_s = 0.0
    flush_bytes = []
    for step in range(start, args.decode_steps):
        t0 = time.perf_counter()
        token, cache = decode_fn(params, cache, token)
        tokens[:, p0 + 1 + step] = token[:, 0]
        _sync(device)
        t1 = time.perf_counter()
        decode_s += t1 - t0
        before = mgr.stats.bytes_written
        state = {"cache": cache, "tokens": tokens}
        if mgr.maybe_flush(step + 1, state):
            flush_s += time.perf_counter() - t1
            flush_bytes.append(mgr.stats.bytes_written - before)
            if on_flush is not None:
                on_flush(step + 1, state, arena)
        if args.inject_failure_at and step + 1 == args.inject_failure_at:
            raise SimulatedFailure(f"injected failure at decode step {step + 1}")
    out = host_array(tokens)
    n = args.decode_steps - start
    st = mgr.stats
    stats: Dict[str, Any] = {
        "decode_steps": n,
        "tokens_per_s": n * args.prompts / max(decode_s, 1e-9),
        "blocks_written": st.blocks_written,
        "bytes_written": st.bytes_written,
        "resumed": resumed,
        "output_shape": list(out.shape),
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_step": decode_s * 1e3 / max(n, 1),
        "flush_ms": flush_s * 1e3,
        "flush_bytes": flush_bytes,
        "flush_split_ms": {k: getattr(st, k) * 1e3
                           for k in ("mask_seconds", "copy_seconds", "arena_seconds")},
    }
    print("[done]", stats)
    stats["tokens"] = out
    mgr.close()
    return stats


def fleet_report(stats: Dict[str, float], args) -> Dict[str, dict]:
    """Project this server's *measured* serving process onto a replica fleet.

    The single-process run measures the two quantities the fleet simulator
    needs from the real system: the per-step decode time (service rate) and
    the delta-flush traffic (``bytes_written`` -> ``t_s`` via
    :func:`~repro.core.efficiency.persist_overhead_fraction`).  Everything
    else — arrivals, failures, recovery policy — is simulated, so the same
    binary answers "what would this server's goodput/p99 look like across N
    replicas under paper-like failure rates?".
    """
    from ..core import (
        POLICIES,
        ArrivalProcess,
        FleetConfig,
        PoissonTrace,
        RecomputeProfile,
        ServiceModel,
        SystemConfig,
        fleet_frontier,
        persist_overhead_fraction,
    )

    steps = max(int(stats["decode_steps"]), 1)
    step_time = args.prompts / max(stats["tokens_per_s"], 1e-9)
    t_s = persist_overhead_fraction(stats["bytes_written"] / steps, step_time)
    # decode sessions are S1-dominant (the KV cache is the session and it is
    # what we persist); the tail mirrors the decode campaign's shape
    profile = RecomputeProfile.from_fractions(
        "serve", {"S1": 0.9, "S2": 0.06, "S3": 0.02, "S4": 0.02},
        extra_iters_hist=((2, 3), (8, 1)),
    )
    service_s = args.decode_steps * step_time
    rate = args.fleet_rate
    if rate <= 0:  # auto: offer ~80% of fleet capacity at the measured speed
        rate = 0.8 * args.fleet_replicas / max(service_s, 1e-3)
    cfg = FleetConfig(
        n_replicas=args.fleet_replicas,
        arrival=ArrivalProcess(rate=rate, amplitude=0.3),
        service=ServiceModel(mean_s=max(service_s, 1e-3), sigma=0.6,
                             prefill_s=max(args.prompt_len * step_time, 1e-3)),
        trace=PoissonTrace(mtbf=args.fleet_mtbf),
        system=SystemConfig(mtbf=args.fleet_mtbf, t_chk=30.0,
                            nvm_restore_time=2.0),
        slo_latency=4.0 * max(service_s, 1e-3),
        queue_cap=48,
        horizon=args.fleet_horizon,
        t_s=t_s,
        t_iter=step_time,
        seed=args.seed,
    )
    print(f"[fleet] measured t_s={t_s:.4f} step={step_time*1e3:.2f}ms "
          f"service={service_s:.2f}s; {cfg.n_replicas} replicas, "
          f"mtbf={cfg.trace.mtbf:.0f}s, horizon={cfg.horizon:.0f}s")
    doc = fleet_frontier(cfg, profile)
    for policy in POLICIES:
        p = doc["policies"][policy]
        print(f"[fleet] {policy:10s} goodput={p['goodput']:.3f}rps "
              f"loss={p['dropped']/max(p['arrived'],1):.3f} "
              f"slo={p['slo_violation_frac']:.3f} "
              f"p99={p['latency_p99']:.2f}s fails={p['n_failures']}")
    return doc["policies"]


def _splice_cache(cfg, full_cache: Dict[str, Any], prefill_cache: Dict[str, Any],
                  prompt_len: int) -> Dict[str, Any]:
    """Install the prefill's cache into the right-sized decode cache, in
    place: K/V caches (L, B, S, H, D) take the prefix along S; a leaf of
    the decode cache's own shape (the recurrent states S, x_last, h, conv,
    and a windowed K/V cache the prompt filled) is copied whole."""
    def splice(dst, src):
        if isinstance(dst, dict):
            return {k: splice(dst[k], src[k]) for k in dst}
        if dst.shape == src.shape:
            return dst.copy_(src)
        if dst.dim() >= 3 and src.dim() == dst.dim():
            n = min(src.shape[2], dst.shape[2])
            dst[:, :, :n] = src[:, :, :n]
        return dst

    out = splice({k: v for k, v in full_cache.items() if k != "t"},
                 {k: v for k, v in prefill_cache.items() if k != "t"})
    out["t"] = torch.tensor(prompt_len, dtype=torch.int32, device=full_cache["t"].device)
    return out


def parser() -> argparse.ArgumentParser:
    """The CLI: the JAX launcher's flags, plus --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--flush-every", type=int, default=8)
    ap.add_argument("--persist-mode", default="delta",
                    choices=("auto", "delta", "full"),
                    help="flush granularity: arena byte diff / delta_snapshot "
                         "kernel (changed blocks only) / whole-object rewrite")
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failure-at", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a CUDA device) or cpu")
    ap.add_argument("--fleet", action="store_true",
                    help="after serving, project the measured step time and "
                         "persist traffic onto a replica fleet under "
                         "failures (repro_torch.core.fleetsim policy comparison)")
    ap.add_argument("--fleet-replicas", type=int, default=4)
    ap.add_argument("--fleet-rate", type=float, default=0.0,
                    help="fleet offered load, requests/s "
                         "(<= 0: auto, ~80%% of measured fleet capacity)")
    ap.add_argument("--fleet-mtbf", type=float, default=900.0,
                    help="per-replica MTBF, seconds")
    ap.add_argument("--fleet-horizon", type=float, default=1800.0)
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    try:
        stats = run(args)
    except SimulatedFailure as e:
        print(f"[failure] {e}; restarting...")
        args.inject_failure_at = 0
        stats = run(args)
    if args.fleet:
        stats["fleet"] = fleet_report(stats, args)
    return stats


if __name__ == "__main__":
    main()
