# Port of repro/core/lane_driver.py.  f32_monotone_cutoff, _pow2,
# _plan_buckets and cached_driver are copied as they are.  What differs:
# * JitLaneDriver's donated lax.while_loop becomes LaneDriver's loop of
#   fixed chunks of CHUNK masked steps, all on the device, with one host
#   read of ``active.any()`` after each chunk to decide whether to run
#   another.  A lane frozen mid-chunk stays frozen: torch.where selects
#   bits, so the chunk's extra masked steps change no value.
# * On the card each chunk is a CUDA graph, captured once per padded bucket
#   size (after a warm-up chunk on a side stream) over static buffers that
#   the caller's stacked lanes are copied into: O(log lanes) graphs, as JAX
#   keeps O(log lanes) jit entries.  On the CPU the same chunk runs eagerly.
# * LaneSpec carries the device; its consts are tensors on it, built once
#   per driver before any capture.  A step and a check run inside a graph,
#   so they read no tensor value on the host (no .item(), no Python branch
#   on a tensor), make no host-to-device copy (constants are fills) and
#   call no op that synchronizes (torch.bincount, nonzero).
# * The carried counters keep their int64 (jit without x64 carries int32).
# * STATS counts buckets, chunks, graph captures and replays.
"""Device-resident multi-window lane driver for the vectorized campaign engine.

The crash tester's phase A advances every restart lane through the
run-to-completion loop.  Stepping it from the host costs a host round trip
and a fresh set of launches per iteration; this module runs the loop on the
device instead, one bucket of stacked lanes at a time:

* the per-lane carried state is stacked into struct-of-arrays buffers
  (padded to the next power of two so the graph cache stays bounded);
* a chunk of masked steps advances all lanes together with per-lane
  ``active`` masks replicating the serial control flow (step, increment,
  converged check, iteration bound), lanes freezing in place as they finish;
* convergence decisions that the serial path takes on the host move to the
  device only where they are *provably identical*: exact-op predicates (max /
  abs / compare / isfinite) and scalar thresholds precomputed with
  :func:`f32_monotone_cutoff`;
* any lane whose decision the device cannot make bit-exactly (non-finite
  decision scalars, conservative overflow screens) raises a sticky ``bad``
  flag instead, and the caller re-runs that lane through the untouched
  serial classifier: over-flagging costs speed, never correctness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Carry = Dict[str, torch.Tensor]

#: masked steps per chunk: the most steps a bucket runs past its last lane
CHUNK = 8


@dataclass
class DriverStats:
    buckets: int = 0
    chunks: int = 0
    captures: int = 0
    replays: int = 0


#: counts over every driver of the process
STATS = DriverStats()


def f32_monotone_cutoff(pred: Callable[[float], bool]) -> np.float32:
    """Largest non-negative float32 ``v`` with ``pred(float(v))`` true.

    ``pred`` must be monotone over the non-negative float32 range: true on
    an initial segment ``[0, v*]`` and false beyond.  This turns a host-side
    float64 convergence predicate of a single float32 scalar (``sqrt(rho)/nb
    < tol`` and friends) into the bit-exact device comparison ``x <= cutoff``
    — every float32 is exactly representable in float64, so the decision
    boundary between adjacent float32 values is exact.

    Returns ``-inf`` when even ``pred(0.0)`` is false (no value converges).
    """
    def val(bits: int) -> float:
        return float(np.array([bits], np.uint32).view(np.float32)[0])

    if not pred(0.0):
        return np.float32(-np.inf)
    lo, hi = 0, 0x7F7F_FFFF  # bit patterns of +0.0 and float32 max
    if pred(val(hi)):
        return np.float32(val(hi))
    # positive float32 bit patterns are ordered like their values, so a
    # 31-step bisection over the bit space finds the exact boundary
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pred(val(mid)):
            lo = mid
        else:
            hi = mid
    return np.float32(val(lo))


@dataclass(frozen=True)
class LaneSpec:
    """One app's device-resident phase-A loop.

    ``carry``
        State fields stacked per lane (axis 0 = lane).  Everything else in
        the state dict is lane-constant or recomputed before read and is
        left untouched in the returned states.
    ``consts``
        Builds the lane-constant device operands (read-only objects such as
        ``b`` / ``links`` / ``points``) from one lane's restart state —
        ``restart_init`` rebuilds them identically for every lane.
    ``step``
        ``step(consts, carry) -> carry``: one main-loop iteration on the
        stacked tensors, bitwise identical per lane to ``run_iteration``.
    ``check``
        ``check(consts, carry, it) -> (conv, suspect)``: the serial
        ``converged(state, it)`` decision *after* a step, as two boolean
        lane vectors.  ``conv`` mirrors the early-exit (including the
        ``it >= n_iters`` bound); ``suspect`` marks lanes where the serial
        hook would raise or where bit-exactness cannot be guaranteed on the
        device — those lanes are handed back for serial reclassification.
    ``device``
        Where the lanes run.
    """

    carry: Tuple[str, ...]
    consts: Callable[[Mapping[str, np.ndarray]], Dict[str, torch.Tensor]]
    step: Callable[[Dict[str, torch.Tensor], Carry], Carry]
    check: Callable[[Dict[str, torch.Tensor], Carry, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]
    device: str = "cpu"


class _Graph:
    """One bucket size's chunk, captured over static buffers."""

    def __init__(self, driver: "LaneDriver", carry: Carry, it, act, stop):
        self.carry = {k: v.clone() for k, v in carry.items()}
        self.it, self.act, self.stop = it.clone(), act.clone(), stop.clone()
        self.bad = torch.zeros_like(act)
        dev = act.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up: allocator pools, library handles
            driver._chunk(self.carry, self.it, self.act, self.bad, self.stop)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            c, i, a, b = driver._chunk(self.carry, self.it, self.act, self.bad, self.stop)
            for k in self.carry:
                self.carry[k].copy_(c[k])
            self.it.copy_(i)
            self.act.copy_(a)
            self.bad.copy_(b)
        STATS.captures += 1

    def load(self, carry: Carry, it, act, stop) -> None:
        for k, v in carry.items():
            self.carry[k].copy_(v)
        self.it.copy_(it)
        self.act.copy_(act)
        self.stop.copy_(stop)
        self.bad.zero_()


class LaneDriver:
    """Runs a :class:`LaneSpec` as chunks of masked steps on its device.

    One instance per app configuration and device (cache with
    :func:`cached_driver` so app objects stay picklable for the campaign
    process pool); on the card it keeps one captured graph per padded
    bucket size.
    """

    def __init__(self, spec: LaneSpec):
        self.spec = spec
        self.chunk = CHUNK
        self.device = spec.device
        #: whether a chunk runs as a captured CUDA graph (on the card) or
        #: eagerly (on the CPU, or when set False)
        self.graphs = torch.device(spec.device).type == "cuda"
        self._consts: Dict[str, torch.Tensor] | None = None
        self._graphs: Dict[int, _Graph] = {}

    def _chunk(self, carry: Carry, it, act, bad, stop):
        spec, consts = self.spec, self._consts
        for _ in range(self.chunk):
            new = spec.step(consts, carry)
            carry = {k: torch.where(act.reshape(act.shape + (1,) * (new[k].dim() - 1)),
                                    new[k], carry[k]) for k in carry}
            it = it + act.to(it.dtype)
            conv, suspect = spec.check(consts, carry, it)
            bad = bad | (act & suspect)
            act = act & ~suspect & ~conv & (it < stop)
        return carry, it, act, bad

    def advance(
        self,
        states: Sequence[Mapping[str, np.ndarray]],
        its: Sequence[int],
        stop: int,
    ) -> Tuple[List[Mapping[str, np.ndarray]], List[int], List[bool]]:
        """Advance every lane through the run-to-completion loop.

        Replicates ``run_to_completion(state, it, stop)`` per lane: step,
        increment, break on ``converged`` or the iteration bound.  Returns
        ``(states, its, oks)``; ``oks[i]`` false means lane ``i`` tripped
        the suspect mask and is returned *unmodified* — the caller must
        reclassify it through the serial path.

        Lanes enter at scattered restart iterations, and a single bucket
        convoys everyone behind the lane with the most remaining work (every
        padded lane computes every step until the last one exits).  Lanes
        are therefore sorted by remaining iterations and split into a few
        power-of-two buckets when the padded lane-iterations saved clearly
        outweigh an extra dispatch; per-lane results are independent, so the
        regrouping cannot change any value.
        """
        n = len(states)
        rem = [max(0, int(stop) - int(it)) for it in its]
        out_states: List[Mapping[str, np.ndarray]] = [None] * n  # type: ignore[list-item]
        out_its: List[int] = [0] * n
        oks: List[bool] = [False] * n
        todo = []
        for i in range(n):
            if rem[i] == 0:  # run_to_completion would execute nothing
                out_states[i], out_its[i], oks[i] = states[i], int(its[i]), True
            else:
                todo.append(i)
        todo.sort(key=lambda i: -rem[i])
        pos = 0
        for size in _plan_buckets([rem[i] for i in todo]):
            idx = todo[pos:pos + size]
            pos += size
            ss, ii, oo = self._advance_bucket(
                [states[i] for i in idx], [its[i] for i in idx], stop
            )
            for j, i in enumerate(idx):
                out_states[i], out_its[i], oks[i] = ss[j], ii[j], oo[j]
        return out_states, out_its, oks

    def _advance_bucket(
        self,
        states: Sequence[Mapping[str, np.ndarray]],
        its: Sequence[int],
        stop: int,
    ) -> Tuple[List[Mapping[str, np.ndarray]], List[int], List[bool]]:
        spec, dev = self.spec, self.device
        n = len(states)
        if self._consts is None:
            self._consts = spec.consts(states[0])
        b = _pow2(n)
        pad = b - n
        carry = {}
        for f in spec.carry:
            rows = [np.asarray(s[f]) for s in states]
            carry[f] = torch.from_numpy(np.stack(rows + [rows[0]] * pad)).to(dev)
        it0 = np.concatenate([np.fromiter(its, np.int64, n), np.full(pad, int(stop), np.int64)])
        it = torch.from_numpy(it0).to(dev)
        act = torch.from_numpy(it0 < int(stop)).to(dev)
        stop_t = torch.full((), int(stop), dtype=torch.int64, device=dev)
        STATS.buckets += 1
        if self.graphs:
            g = self._graphs.get(b)
            if g is None:
                g = self._graphs[b] = _Graph(self, carry, it, act, stop_t)
            g.load(carry, it, act, stop_t)
            while True:
                g.graph.replay()
                STATS.replays += 1
                STATS.chunks += 1
                if not bool(g.act.any()):
                    break
            carry, it, bad = g.carry, g.it, g.bad
        else:
            bad = torch.zeros_like(act)
            while True:
                carry, it, act, bad = self._chunk(carry, it, act, bad, stop_t)
                STATS.chunks += 1
                if not bool(act.any()):
                    break
        carry = {k: v.cpu().numpy() for k, v in carry.items()}
        itv = it.cpu().numpy()
        bad = bad.cpu().numpy()
        out_states: List[Mapping[str, np.ndarray]] = []
        out_its: List[int] = []
        oks: List[bool] = []
        for i, s in enumerate(states):
            if bad[i]:
                out_states.append(s)
                out_its.append(int(its[i]))
                oks.append(False)
                continue
            s2 = dict(s)
            for f in spec.carry:
                s2[f] = carry[f][i].astype(np.asarray(s[f]).dtype, copy=True)
            out_states.append(s2)
            out_its.append(int(itv[i]))
            oks.append(True)
        return out_states, out_its, oks


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _plan_buckets(rem_desc: Sequence[int]) -> List[int]:
    """Split lanes (sorted by remaining iterations, descending) into bucket
    sizes minimizing padded lane-iterations: a bucket of ``k`` lanes costs
    ``pow2(k) * rem_desc[first]`` while-loop iterations.  An extra bucket is
    an extra dispatch, charged at an eighth of the single-bucket cost so the
    split only happens when it clearly pays."""
    n = len(rem_desc)
    if n == 0:
        return []
    overhead = max(1, (_pow2(n) * rem_desc[0]) // 8)
    best = [0] * (n + 1)  # best[i]: min cost of lanes i..n-1
    cut = [n] * (n + 1)
    for i in range(n - 1, -1, -1):
        best[i] = float("inf")  # type: ignore[assignment]
        for j in range(i + 1, n + 1):
            c = _pow2(j - i) * rem_desc[i] + overhead + best[j]
            if c < best[i]:
                best[i], cut[i] = c, j
    sizes = []
    i = 0
    while i < n:
        sizes.append(cut[i] - i)
        i = cut[i]
    return sizes


_DRIVER_CACHE: Dict[tuple, LaneDriver] = {}


def cached_driver(key: tuple, factory: Callable[[], LaneSpec]) -> LaneDriver:
    """Process-level driver cache keyed by app configuration (the key
    includes the device).

    Apps must not hold driver instances as attributes — the captured graphs
    and closures are unpicklable and would silently knock the app out of the
    campaign process pool.  Worker processes repopulate their own cache on
    first use.
    """
    drv = _DRIVER_CACHE.get(key)
    if drv is None:
        drv = _DRIVER_CACHE[key] = LaneDriver(factory())
    return drv
