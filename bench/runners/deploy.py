"""An iterative app deployed under ``EasyCrashManager``: the paper's loop.

Each iteration runs the app's regions (``repro_torch.core.regions``) and
waits for the device; where the traffic names objects, every
``flush_every``-th iteration ends with a flush of them through
``maybe_flush`` (synchronous; delta flushes by the ``delta_snapshot``
kernel) into an ``NVMArena`` in host memory with no backing file.  Set-up
runs ``warm_iters`` iterations with their flushes (the first flush writes
everything) and loads the kernel.  The window ends at the first iteration
boundary past ``--seconds`` that ends a flush period, so it holds whole
periods.  After it, the live state is dropped ``restore_reps`` times and a
new manager over the same arena restores into fresh device buffers and
runs one iteration.

The output check: the final field and flux against the plain reference
solved from the same seed (``state_gap``), the arena image against the
live bytes and the restored state against the arena image (exact).
"""
from __future__ import annotations

import importlib
import time
from types import SimpleNamespace
from typing import Dict

import torch

from .. import counts
from ..harness import Check
from ..reference.images import differing_bytes
from ..trace import span, sync


def setup(config: Dict, traffic: Dict, seed: int, device: str):
    from repro_torch.core.arena import NVMArena
    from repro_torch.core.manager import EasyCrashManager, FlushPolicy

    app_cls = getattr(importlib.import_module(config["app_module"]), config["app_class"])
    app = app_cls(**config["app_args"], device=device)
    maker = importlib.import_module(f"bench.inputs.{config['inputs']}")
    inputs = maker.make_inputs(config, seed)
    s = SimpleNamespace(config=config, traffic=traffic, device=device, app=app,
                        regions=app.regions(), maker=maker, inputs=inputs, step=0,
                        arena=None, mgr=None, policy=None)
    s.state = maker.make_state(config, inputs, device)
    if traffic["flush_leaves"]:
        s.arena = NVMArena(block_bytes=int(config["block_bytes"]))
        s.policy = FlushPolicy(leaves=tuple(traffic["flush_leaves"]),
                               every_steps=int(traffic["flush_every"]), async_flush=False,
                               persist_mode=traffic["persist_mode"])
        s.mgr = EasyCrashManager(s.arena, s.policy)
    for _ in range(int(traffic["warm_iters"])):  # the first flush writes all
        s.state = _iterate(s, s.state)
        s.step += 1
        if s.mgr is not None:
            s.mgr.maybe_flush(s.step, s.state)
    if s.mgr is not None and device.startswith("cuda"):
        _load_delta_kernel(device)
    sync(device)
    return s


def _load_delta_kernel(device: str) -> None:
    """Build (first run of a checkout) and load ``delta_snapshot``, which
    set-up's first flush, writing everything, does not launch."""
    from repro_torch.kernels.delta_snapshot import dirty_block_mask

    x = torch.zeros(1024, dtype=torch.uint8, device=device)
    dirty_block_mask(x, x, block_elems=64)


def _iterate(s, state):
    for r in s.regions:
        with span("region." + r.name):
            state = r.fn(state)
    sync(s.device)
    return state


def _flushed(s) -> list:
    """The tensor leaves a flush persists (the traffic names them)."""
    return [s.state[name] for name in s.policy.leaves]


def window(s, seconds: float, tracer) -> Dict:
    from repro_torch.kernels.delta_snapshot import dirty_block_mask

    units = []
    traced_units = int(s.traffic["trace_units"]) if tracer is not None else 0
    if tracer is not None:  # the profiler's start and stop are not the window's
        tracer.start()
    paused = 0.0
    t_w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        s.state = _iterate(s, s.state)
        t1 = time.perf_counter()
        s.step += 1
        unit = {"compute_s": t1 - t0, "traced": bool(tracer is not None and tracer.running)}
        if s.mgr is not None:
            st = s.mgr.stats
            before = (st.arena_seconds, st.mask_seconds, st.copy_seconds, dirty_block_mask.launches)
            with span("maybe_flush"):
                flushed = s.mgr.maybe_flush(s.step, s.state)
            if flushed:
                unit.update(flush_s=time.perf_counter() - t1,
                            arena_s=st.arena_seconds - before[0],
                            mask_s=st.mask_seconds - before[1],
                            copy_s=st.copy_seconds - before[2],
                            launches=dirty_block_mask.launches - before[3])
        units.append(unit)
        if tracer is not None and tracer.running and len(units) >= traced_units:
            ts = time.perf_counter()
            tracer.stop()
            paused += time.perf_counter() - ts
        period_end = s.mgr is None or s.step % s.policy.every_steps == 0
        if period_end and time.perf_counter() - t_w0 - paused >= seconds:
            break
    window_s = time.perf_counter() - t_w0 - paused
    if tracer is not None and tracer.running:
        tracer.stop()
    per_iter = importlib.import_module(f"bench.counts.{s.config['counts']}")
    rec = {"kind": "deploy", "window_s": window_s, "units": units, "attempted": len(units),
           "iter_bytes": per_iter.iter_bytes(s.config)}
    if s.mgr is not None:  # one delta_snapshot mask a leaf and flush
        rec["delta_bound_s"] = sum(counts.delta_bound_s(t.numel() * t.element_size(),
                                                        s.arena.block_bytes) for t in _flushed(s))
        rec["leaves"] = len(_flushed(s))
    return rec


def after_window(s, rec: Dict) -> None:
    """The arena image against the live bytes, then the restores (timed)."""
    from repro_torch.core.manager import EasyCrashManager

    s.final = {k: s.state[k] for k in s.config["outputs"]}
    s.image_diff = s.restore_diff = 0
    rec["restore_s"] = []
    if s.mgr is None:
        s.state = None
        return
    for name, live in zip(s.policy.leaves, _flushed(s)):
        s.image_diff += differing_bytes(s.arena.peek(name), live)
    s.image_diff += int(int(s.arena.get("__step__")) != s.step)
    s.state = None  # the crash: the live state and the manager are gone
    s.mgr.close()
    s.mgr = None
    for _ in range(int(s.traffic["restore_reps"])):
        sync(s.device)
        t0 = time.perf_counter()
        with span("restore"):
            mgr = EasyCrashManager(s.arena, s.policy)
            template = s.maker.make_state(s.config, s.inputs, s.device)
            restored, step, source = mgr.restore(template)
            _iterate(s, restored)
        rec["restore_s"].append(time.perf_counter() - t0)
        for name in s.policy.leaves:
            s.restore_diff += differing_bytes(restored[name], s.arena.peek(name))
        s.restore_diff += int(step != s.step or source != "easycrash")
        mgr.close()
        del mgr, template, restored


def check(s, rec: Dict, limits: Dict) -> list:
    ref = importlib.import_module(f"bench.reference.{s.config['reference']}")
    s.app = s.regions = s.mgr = None
    if s.device.startswith("cuda"):
        torch.cuda.empty_cache()
    s.memo = {}
    got = ref.compare(s.config, s.inputs, s.step, s.final, memo=s.memo)
    checks = [Check(k, v, float(limits[k])) for k, v in got.items()]
    if s.arena is not None:
        checks += [Check("image_bytes_differ", s.image_diff, 0.0),
                   Check("restore_bytes_differ", s.restore_diff, 0.0)]
    return checks


def control(s, rec: Dict) -> Dict[str, float]:
    """The control's reading: the reference in bfloat16 in the program's place."""
    ref = importlib.import_module(f"bench.reference.{s.config['reference']}")
    return ref.compare(s.config, s.inputs, s.step, s.final, dtype=torch.bfloat16, memo=s.memo)


def tiny(config: Dict, traffic: Dict):
    """(config, traffic) at a size the CPU tests run in a second: a 64 x 64
    plate, its pins in an 8 x 8 box."""
    return dict(config, app_args=dict(config["app_args"], grid=64), pin_box=8), traffic
