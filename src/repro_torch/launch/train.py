# Port of repro/launch/train.py.  What differs:
# * --device (default cuda; raises without CUDA unless --device cpu), and
#   the default --workdir is build/repro_torch_train in the repository.
# * The train state stays on the device.  The manager gets its tensors and
#   clones the flushed leaves at flush time: there is no per-step host
#   copy.  checkpoint_save hands the state's tensors to the checkpoint
#   manager, whose writer copies each leaf to the host; checkpoint_restore
#   puts a checkpoint back on the device with the template's dtypes.
# * The initial weights come from a torch.Generator seeded with --seed on
#   the device (JAX's PRNGKey(seed) gives other numbers).
# * run(args, cfg=None, on_flushed=None, on_restore=None) also takes the
#   model config from its caller (to cut depth at full width), a hook run
#   after each flush lands (on the manager's writer thread when flushes are
#   asynchronous) and a hook run on the restored state, and returns its
#   stats (main() returns the last run's).  They add the step and flush
#   timings, the manager's mask / device-to-host / arena seconds, the
#   checkpoint writes' seconds and bytes, the checkpoint cadence, and the
#   restore's source, step and milliseconds.
# * A simulated failure closes the manager and the checkpoint manager
#   (their threads) before it propagates, as the process's death would end
#   them; the crash still strikes after the in-flight flushes land.
"""Production training driver: EasyCrash + multilevel C/R + failure injection.

Runs a (reduced-by-default) architecture for N steps on one device,
wiring together every fault-tolerance layer this framework provides:

  * EasyCrash flushes of the *critical* state subset (params + step — the
    selection the crash campaigns find; Adam moments re-warm) to a
    host-local NVM arena, asynchronously, every ``--flush-every`` steps;
  * multilevel checkpoints at the Young interval stretched by measured
    recomputability (MTBF' = MTBF / (1 - R));
  * deterministic, seekable data (restart needs only the step counter);
  * ``--inject-failure-every K`` kills the loop mid-step every K steps; the
    driver then restores via EasyCrash -> checkpoint -> fresh, with a
    loss-based acceptance verification guarding the EasyCrash path.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 30 --inject-failure-every 14 --width 64 --seq 32 --batch 4
"""
from __future__ import annotations

import argparse
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointConfig, CheckpointManager, tree_nbytes
from ..checkpoint.serialization import flatten_tree
from ..configs import get_arch
from ..convert import to_tensor
from ..core.arena import NVMArena
from ..core.manager import EasyCrashManager, FlushPolicy, flatten_state, unflatten_state
from ..data import DataConfig, SyntheticLMStream
from ..device import resolve_device
from ..models import loss_and_aux, scaled_down
from .steps import init_train_state, make_train_step

DEFAULT_WORKDIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_train"


class SimulatedFailure(RuntimeError):
    pass


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)


def _on_device(batch: Mapping[str, np.ndarray], device: str) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build(args, cfg=None):
    if cfg is None:
        cfg = get_arch(args.arch)
        if not args.full_size:
            cfg = scaled_down(cfg, width=args.width)
    data_cfg = DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
    )
    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps)
    return cfg, data_cfg, step_fn


def run(args, cfg=None,
        on_flushed: Optional[Callable[[int, Mapping[str, Any], NVMArena], None]] = None,
        on_restore: Optional[Callable[[Dict[str, Any], int, str], None]] = None,
        ) -> Dict[str, Any]:
    device = resolve_device(args.device)
    cfg, data_cfg, step_fn = build(args, cfg)
    os.makedirs(args.workdir, exist_ok=True)
    arena_dir = os.path.join(args.workdir, "arena")
    ckpt = CheckpointManager(CheckpointConfig(
        local_dir=os.path.join(args.workdir, "ckpt_local"),
        remote_dir=os.path.join(args.workdir, "ckpt_remote"),
    ))
    init_state = init_train_state(cfg, torch.Generator(device=device).manual_seed(args.seed))
    dtypes = {name: t.dtype for name, t in flatten_state(init_state).items()}

    def checkpoint_save(step: int, state) -> None:
        ckpt.save(step, state)

    def checkpoint_restore():
        got = ckpt.restore()
        if got is None:
            return None
        step, tree = got
        flat = flatten_tree(tree)
        out = {}
        for name, dtype in dtypes.items():
            t = to_tensor(flat[name], device, dtype)
            out[name] = t if t.dtype == dtype else t.to(dtype)
        return step, unflatten_state(out)

    try:
        arena = NVMArena.reattach(arena_dir)
        print(f"[restore] reattached arena with {len(list(arena.names()))} objects")
    except Exception:
        arena = NVMArena(backing_dir=arena_dir)

    policy = FlushPolicy(
        leaves=("params", "step"), every_steps=args.flush_every,
        async_flush=not args.sync_flush,
        persist_mode=args.persist_mode,
    )
    mgr = EasyCrashManager(
        arena, policy,
        checkpoint_save=checkpoint_save,
        checkpoint_restore=checkpoint_restore,
        mtbf=args.mtbf, t_chk=args.t_chk,
        recomputability=args.recomputability, step_time=1.0,
        on_flushed=on_flushed,
    )

    def verify(candidate, step) -> bool:
        """Acceptance verification: one forward loss must be finite and sane."""
        try:
            stream0 = SyntheticLMStream(data_cfg, 0, 1, start_step=step)
            _, batch = next(stream0)
            stream0.close()
            with torch.no_grad():
                loss, _ = loss_and_aux(cfg, candidate["params"], _on_device(batch, device))
            loss = float(loss)
            ok = bool(math.isfinite(loss) and loss < args.verify_loss_max)
            print(f"[verify] step={step} loss={loss:.3f} -> {'ACCEPT' if ok else 'REJECT'}")
            return ok
        except Exception as e:  # noqa: BLE001
            print(f"[verify] failed: {e}")
            return False

    _sync(device)
    t0 = time.perf_counter()
    state, start_step, source = mgr.restore(init_state, verify=verify)
    _sync(device)
    restore_s = time.perf_counter() - t0
    del init_state  # the restored state holds what it still needs
    print(f"[restore] source={source} step={start_step}")
    state["step"] = torch.tensor(start_step, dtype=torch.int32, device=device)
    if on_restore is not None:
        on_restore(state, start_step, source)

    stream = SyntheticLMStream(data_cfg, 0, 1, start_step=start_step)
    losses, step_ms = [], []
    step = start_step
    step_s = flush_s = ckpt_s = 0.0
    ckpt_bytes = 0
    try:
        while step < args.steps:
            t0 = time.perf_counter()
            _, batch = next(stream)
            state, metrics = step_fn(state, _on_device(batch, device))
            step += 1
            loss = float(metrics["loss"])  # waits for the step, as JAX's float() does
            losses.append(loss)
            t1 = time.perf_counter()
            step_s += t1 - t0
            step_ms.append((t1 - t0) * 1e3)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(step_s + flush_s) / max(1, step - start_step):.2f}s/step)")
            t1 = time.perf_counter()
            mgr.maybe_flush(step, state)
            t2 = time.perf_counter()
            flush_s += t2 - t1
            if mgr.maybe_checkpoint(step, state):
                ckpt_bytes = tree_nbytes(state)
            ckpt_s += time.perf_counter() - t2
            if args.inject_failure_every and step % args.inject_failure_every == 0 \
                    and step < args.steps:
                mgr.barrier()  # crash strikes after in-flight flushes land
                raise SimulatedFailure(f"injected failure at step {step}")
        mgr.barrier()
    finally:
        stream.close()
        mgr.close()
        ckpt.close()
    n = max(1, step - start_step)
    st = mgr.stats
    stats: Dict[str, Any] = {
        "final_step": step,
        "final_loss": losses[-1] if losses else float("nan"),
        "flushes": st.flushes_issued,
        "flushes_skipped": st.flushes_skipped,
        "blocks_written": st.blocks_written,
        "bytes_written": st.bytes_written,
        "checkpoints": st.checkpoints_taken,
        "easycrash_restores": st.easycrash_restores,
        "checkpoint_restores": st.checkpoint_restores,
        "restore_source": source,
        "restore_step": start_step,
        "restore_ms": restore_s * 1e3,
        "steps_run": step - start_step,
        "ms_per_step": (step_s + flush_s) * 1e3 / n,
        "ms_per_step_without_flush_calls": step_s * 1e3 / n,
        "step_ms": step_ms,
        "flush_call_ms": flush_s * 1e3,
        "checkpoint_call_ms": ckpt_s * 1e3,
        "flush_split_ms": {k: getattr(st, k) * 1e3
                           for k in ("mask_seconds", "copy_seconds", "arena_seconds")},
        "checkpoint_save_s": list(ckpt.save_seconds),
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_every": mgr.checkpoint_every,
    }
    print("[done]", stats)
    return stats


def parser() -> argparse.ArgumentParser:
    """The CLI: the JAX launcher's flags, plus --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config; default reduced")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--flush-every", type=int, default=1)
    ap.add_argument("--sync-flush", action="store_true")
    ap.add_argument("--persist-mode", default="auto",
                    choices=("auto", "delta", "full"),
                    help="flush granularity: arena byte diff / delta_snapshot "
                         "kernel (changed blocks only) / whole-object rewrite")
    ap.add_argument("--mtbf", type=float, default=300.0)
    ap.add_argument("--t-chk", type=float, default=5.0)
    ap.add_argument("--recomputability", type=float, default=0.82)
    ap.add_argument("--verify-loss-max", type=float, default=20.0)
    ap.add_argument("--inject-failure-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a CUDA device) or cpu")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    restarts = 0
    while True:
        try:
            return run(args)
        except SimulatedFailure as e:
            restarts += 1
            print(f"[failure] {e} (restart {restarts})")
            if restarts > args.max_restarts:
                raise


if __name__ == "__main__":
    main()
