"""A decode server deployed under ``EasyCrashManager``: the port's serving
path (``launch/serve.py``) at a configuration's published widths.

Set-up draws the weights and the sessions' prompts from the seed, sizes the
decode cache (``init_cache``) to the context plus ``extra_positions``,
prefills the sessions through ``make_prefill_step`` in groups of
``prefill_group`` and installs each group's cache with ``_splice_cache``,
then runs ``warm_steps`` decode steps with their flush (the first writes
everything) and loads the delta kernel.  A unit of the window is one greedy
decode step of every session (``make_decode_fn``), waited for; every
``flush_every``-th ends with a synchronous ``maybe_flush`` of the traffic's
leaves (the cache and the token buffer) into an ``NVMArena`` in host memory
with no backing file.  The window ends at the first step past ``--seconds``
that ends a flush period; a traced run's window ends on an untraced flush,
so its host-clock metrics have steps to read.  A step that would write past the cache's
capacity stops the run with an error: the window is never cut short.  A
flush's unit records its parts (arena, mask and copy seconds) and its
``delta_snapshot`` launches; the record holds the leaves flushed and their
masks' byte bound, as the heat runner's does.

After the window: the arena image against the live bytes; the checked
sessions' last logits and Mamba-2 states; then ``restore_reps`` times the
live cache is dropped and a new manager over the same arena restores into
fresh device buffers and runs one decode step (timed together).

The output check holds the checked sessions' last logits and states to the
plain reference's full forward over prompt and decoded tokens
(``logit_gap``, ``state_gap``: max abs gap over the reference's max), and
the arena and restored images to the live bytes (exact).
"""
from __future__ import annotations

import importlib
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from ..harness import Check
from ..reference.images import differing_bytes
from ..trace import span, sync


def _rows(tree: Dict, b0: int, b1: int) -> Dict:
    """The cache's groups restricted to sessions b0:b1 (views)."""
    return {k: _rows(v, b0, b1) if isinstance(v, dict) else v[:, b0:b1] for k, v in tree.items()}


def _flat(state: Dict) -> Dict[str, torch.Tensor]:
    from repro_torch.core.manager import flatten_state

    return flatten_state(state)


def setup(config: Dict, traffic: Dict, seed: int, device: str):
    inputs = importlib.import_module(f"bench.inputs.{config['inputs']}")
    cfg = inputs.port_config(config)  # first: a program without the arch fails here, soon
    from repro_torch.core.arena import NVMArena
    from repro_torch.core.manager import EasyCrashManager, FlushPolicy
    from repro_torch.launch.serve import _splice_cache
    from repro_torch.launch.steps import make_decode_fn, make_prefill_step
    from repro_torch.models import init_cache

    counts = importlib.import_module(f"bench.counts.{config['counts']}")
    n, p0 = int(traffic["sessions"]), int(traffic["context"])
    s = SimpleNamespace(config=config, traffic=traffic, device=device, cfg=cfg, counts=counts,
                        p0=p0, max_len=p0 + int(traffic["extra_positions"]), step=0)
    s.params = inputs.make_weights(cfg, config, seed, device)
    s.check_idx = inputs.check_sessions(traffic, seed)
    prompts = inputs.make_prompts(config, traffic, seed, device)
    s.decode_fn = make_decode_fn(cfg)
    s.cache = init_cache(cfg, n, s.max_len, device)
    s.tokens = torch.zeros((n, s.max_len), dtype=torch.int32, device=device)
    s.tokens[:, :p0] = prompts
    prefill_fn = make_prefill_step(cfg, "kernel" if device.startswith("cuda") else "reference")
    group = int(traffic["prefill_group"])
    with torch.no_grad():
        for b0 in range(0, n, group):
            b1 = min(b0 + group, n)
            logits, pcache = prefill_fn(s.params, {"tokens": prompts[b0:b1]})
            view = {"t": s.cache["t"], **_rows({k: v for k, v in s.cache.items() if k != "t"},
                                                b0, b1)}
            _splice_cache(cfg, view, pcache, p0)
            s.tokens[b0:b1, p0] = logits.argmax(dim=-1).to(torch.int32)
            del logits, pcache
    s.cache["t"] = torch.tensor(p0, dtype=torch.int32, device=device)
    del prompts
    s.arena = NVMArena(block_bytes=int(config["block_bytes"]))
    s.policy = FlushPolicy(leaves=tuple(traffic["flush_leaves"]),
                           every_steps=int(traffic["flush_every"]), async_flush=False,
                           persist_mode=traffic["persist_mode"])
    s.mgr = EasyCrashManager(s.arena, s.policy)
    for _ in range(int(traffic["warm_steps"])):  # the first flush writes everything
        s.cache, _ = _step(s, s.cache, s.tokens, s.step)
        s.step += 1
        s.mgr.maybe_flush(s.step, _state(s))
    if device.startswith("cuda"):
        from repro_torch.kernels.delta_snapshot import dirty_block_mask

        x = torch.zeros(1024, dtype=torch.uint8, device=device)
        dirty_block_mask(x, x, block_elems=64)  # built and loaded before the window
    sync(device)
    return s


def _state(s) -> Dict:
    return {"cache": s.cache, "tokens": s.tokens}


def _step(s, cache: Dict, tokens: torch.Tensor, done: int):
    """Decode step ``done + 1`` of every session, greedy, waited for;
    returns the cache (its leaves updated in place, a new position ``t``)
    and the step's logits.  Raises rather than write past the cache's
    capacity."""
    pos = s.p0 + done  # the position the step writes
    if pos + 1 >= s.max_len:
        raise RuntimeError(f"decode step {done + 1} would pass the cache's capacity of "
                           f"{s.max_len} positions: raise extra_positions")
    with torch.no_grad(), span("decode"):
        token, cache, logits = s.decode_fn(s.params, cache, tokens[:, pos:pos + 1])
        tokens[:, pos + 1] = token[:, 0]
    sync(s.device)
    return cache, logits


def window(s, seconds: float, tracer) -> Dict:
    from repro_torch.kernels.delta_snapshot import dirty_block_mask
    from repro_torch.kernels.ssm_update import ssm_update

    from .. import counts

    units: List[Dict] = []
    traced_units = int(s.traffic["trace_units"]) if tracer is not None else 0
    n = int(s.traffic["sessions"])
    if tracer is not None:  # the profiler's start and stop are not the window's
        tracer.start()
    paused = 0.0
    t_w0 = time.perf_counter()
    while True:
        launches = ssm_update.launches
        length = s.p0 + s.step + 1  # positions this step attends
        t0 = time.perf_counter()
        s.cache, s.logits = _step(s, s.cache, s.tokens, s.step)
        t1 = time.perf_counter()
        s.step += 1
        unit = {"compute_s": t1 - t0, "traced": bool(tracer is not None and tracer.running),
                "bound_s": s.counts.decode_step_bound_s(s.config, n, length),
                "ssm_launches": ssm_update.launches - launches}
        st = s.mgr.stats
        before = (st.arena_seconds, st.mask_seconds, st.copy_seconds, dirty_block_mask.launches)
        with span("maybe_flush"):
            flushed = s.mgr.maybe_flush(s.step, _state(s))
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
        period_end = s.step % s.policy.every_steps == 0
        if period_end and time.perf_counter() - t_w0 - paused >= seconds \
                and not units[-1]["traced"]:  # a traced run ends on an untraced flush
            break
    window_s = time.perf_counter() - t_w0 - paused
    if tracer is not None and tracer.running:
        tracer.stop()
    leaves = list(_flat(_state(s)).values())  # one delta_snapshot mask a leaf and flush
    return {"window_s": window_s, "units": units, "attempted": len(units),
            "ssm_bound_s": s.counts.ssm_update_bound_s(s.config, n), "leaves": len(leaves),
            "delta_bound_s": sum(counts.delta_bound_s(t.numel() * t.element_size(),
                                                      s.arena.block_bytes) for t in leaves)}


def _mamba_states(s, cache: Dict, idx: List[int]) -> torch.Tensor:
    """The sessions' Mamba-2 states, layer by layer: (layers, sessions, H, P, N)."""
    out = []
    for gi, (pattern, n) in enumerate(s.cfg.groups):
        for i in range(n):
            for pi, kind in enumerate(pattern):
                if kind == "mamba":
                    out.append(cache[f"group{gi}"][f"pos{pi}"]["ssm"][i, idx])
    return torch.stack(out)


def after_window(s, rec: Dict) -> None:
    """The arena image against the live bytes, the checked sessions' outputs,
    then the restores (timed)."""
    from repro_torch.core.manager import EasyCrashManager
    from repro_torch.models import init_cache

    idx = s.check_idx
    s.final_logits = s.logits[idx].float()
    s.final_states = _mamba_states(s, s.cache, idx)
    s.fed = s.tokens[idx, :s.p0 + s.step].clone()
    s.logits = None
    s.image_diff = sum(differing_bytes(s.arena.peek(name), live)
                       for name, live in _flat(_state(s)).items())
    s.image_diff += int(int(s.arena.get("__step__")) != s.step)
    s.cache = s.tokens = None  # the crash: the live state and the manager are gone
    s.mgr.close()
    s.mgr = None
    s.restore_diff = 0
    rec["restore_s"] = []
    n = int(s.traffic["sessions"])
    for _ in range(int(s.traffic["restore_reps"])):
        sync(s.device)
        t0 = time.perf_counter()
        with span("restore"):
            mgr = EasyCrashManager(s.arena, s.policy)
            template = {"cache": init_cache(s.cfg, n, s.max_len, s.device),
                        "tokens": torch.zeros((n, s.max_len), dtype=torch.int32,
                                              device=s.device)}
            restored, step, source = mgr.restore(template)
            sync(s.device)
        dt = time.perf_counter() - t0
        s.restore_diff += sum(differing_bytes(live, s.arena.peek(name))
                              for name, live in _flat(restored).items())
        s.restore_diff += int(step != s.step or source != "easycrash")
        t0 = time.perf_counter()
        _step(s, restored["cache"], restored["tokens"], step)  # the resumed step
        rec["restore_s"].append(dt + time.perf_counter() - t0)
        mgr.close()
        del mgr, template, restored


def _reference(s, lowp: bool):
    ref = importlib.import_module(f"bench.reference.{s.config['reference']}")
    inputs = importlib.import_module(f"bench.inputs.{s.config['inputs']}")
    with torch.no_grad():
        return ref, ref.forward(s.config, inputs.layer_views(s.cfg, s.params), s.fed, lowp=lowp)


def check(s, rec: Dict, limits: Dict) -> list:
    if s.device.startswith("cuda"):
        torch.cuda.empty_cache()
    ref, (logits, states) = _reference(s, lowp=False)
    s.memo = (logits, states)
    got = {"logit_gap": ref.relative_gap(s.final_logits, logits),
           "state_gap": ref.relative_gap(s.final_states, states)}
    checks = [Check(k, v, float(limits[k])) for k, v in got.items()]
    return checks + [Check("image_bytes_differ", s.image_diff, 0.0),
                     Check("restore_bytes_differ", s.restore_diff, 0.0)]


def control(s, rec: Dict) -> Dict[str, float]:
    """The control's readings: the reference one precision below the
    program's bfloat16 (float8 e4m3 weights and products' inputs, bfloat16
    states) in the program's place."""
    ref, (logits, states) = _reference(s, lowp=True)
    want_logits, want_states = s.memo
    return {"logit_gap": ref.relative_gap(logits, want_logits),
            "state_gap": ref.relative_gap(states, want_states)}


def tiny(config: Dict, traffic: Dict):
    """(config, traffic) at a size the CPU tests run in a few seconds: width
    128, eight layers (three runs of Mamba-2 layers around two attention
    layers), float32, three sessions of 21 tokens prefilled in groups of
    two.  The weights' std is 0.15, so that at this width the layers'
    outputs are of unit scale, as the published std gives at 2048, and the
    control's rounding shows as it does at full width."""
    small = dict(config, hidden_size=128, intermediate_size=256, shared_intermediate_size=256,
                 num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=16,
                 mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8, vocab_size=256,
                 layer_types=["mamba", "mamba", "attention", "mamba", "mamba", "mamba",
                              "attention", "mamba"],
                 num_hidden_layers=8, dtype="float32", initializer_range=0.15)
    return small, dict(traffic, sessions=3, context=21, prefill_group=2)
