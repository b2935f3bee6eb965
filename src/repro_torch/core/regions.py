# Port copy of repro/core/regions.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
# The port's BatchedKernel.fn is a torch function; nothing here traces it.
"""Application abstraction: iterative apps as chains of code regions.

The paper models an HPC application as a main computation loop containing
first-level inner loops; a *code region* is one inner loop or the straight-
line code between two of them (§5.2).  Here an app declares its regions
explicitly: each region is a pure, jittable transition on the app state that
also declares which data objects it reads and writes (in sweep order), which
is what drives the NVCT cache model.

State is a flat ``dict[str, np.ndarray]``.  Heap/global data objects whose
lifetime is the main loop and which are not read-only are the *candidates*
for critical-object selection (§5.1); everything else is rebuilt by
``restart_init`` on recovery.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

State = Dict[str, np.ndarray]


@dataclass(frozen=True)
class Region:
    """One code region of the main loop."""

    name: str
    fn: Callable[[State], State]
    writes: Tuple[str, ...]              # objects written, in sweep order
    reads: Tuple[str, ...] = ()
    cost: float = 1.0                    # relative execution-time weight (a_k)
    loop: bool = True                    # has loop structure (flush freq x applies)
    hot_reads: Tuple[str, ...] = ()      # small objects re-read continuously


@dataclass(frozen=True)
class VerifyResult:
    passed: bool
    metric: float
    detail: str = ""

    def spec(self) -> Dict[str, object]:
        """JSON-round-trip-safe identity (fingerprint input)."""
        m = float(self.metric)
        return {
            "passed": bool(self.passed),
            "metric": m if m == m and abs(m) != float("inf") else None,
            "detail": str(self.detail),
        }


@dataclass(frozen=True)
class BatchedKernel:
    """One batched-lane kernel of a ``supports_batched_step`` app, exposed
    for the bitwise-batchability lint (:mod:`repro.analysis.determinism_lint`).

    ``fn(*args)`` must be traceable by :func:`jax.make_jaxpr`; ``batched``
    maps argument positions to the lane axis (axis 0 by convention).  Static
    configuration (grid size, loop counts) is closed over, not passed.
    """

    name: str
    fn: Callable
    args: Tuple
    batched: Mapping[int, int]


class IterativeApp:
    """Base class for region-structured iterative applications."""

    name: str = "app"
    n_iters: int = 10
    #: candidates of critical data objects (non-read-only, main-loop lifetime)
    candidates: Tuple[str, ...] = ()
    #: the loop iterator object; always persisted at iteration end (paper
    #: footnote 3: "we always persist a loop iterator to bookmark where the
    #: crash happens ... almost zero impact on performance")
    iterator_object: Optional[str] = "k"
    #: per-app fault-model parameter overrides for crash campaigns:
    #: ``{model_name: {param: value}}``, consumed by
    #: :func:`repro.core.faults.get_fault_model` (and the benchmark fault
    #: sweep).  Apps whose structure makes a failure mode unusually punishing
    #: (or trivial) tune the model here instead of at every call site.
    fault_defaults: Mapping[str, Mapping[str, object]] = {}
    #: opt-in for the vectorized campaign engine: the crash tester may stack
    #: this app's restart lanes and advance them through the ``*_batch``
    #: hooks below.  An app must only set this when its batched hooks are
    #: **bitwise identical** per lane to the serial ones (vmapped elementwise
    #: jax ops are; batched matmuls generally are not — use ``lax.map``).
    supports_batched_step: bool = False
    #: opt-in for the jit-resident lane driver: the crash tester may hand the
    #: whole phase-A run-to-completion loop to :meth:`advance_lanes` (one
    #: jitted ``lax.while_loop`` dispatch per lane bucket instead of one
    #: ``run_iteration_batch`` dispatch per iteration).  Same contract as
    #: ``supports_batched_step``, strengthened: the *convergence decision*
    #: must also be bit-exact in-jit, or the lane must come back flagged
    #: (``ok=False``) for serial reclassification.
    supports_lane_driver: bool = False

    def regions(self) -> Tuple[Region, ...]:
        raise NotImplementedError

    def init(self, seed: int = 0) -> State:
        raise NotImplementedError

    # --------------------------------------------------- static-analysis hooks
    def static_hints(self) -> Mapping[str, str]:
        """Algorithm knowledge the dataflow walker cannot derive, as
        ``{object: hint}``.  Recognized hints: ``"exact-accumulator"`` — the
        object is an exact (bitwise-verified) accumulation, so re-executing a
        crashed iteration double-counts and the object is crash-critical
        regardless of any contraction argument."""
        return {}

    def batched_kernels(self) -> Tuple["BatchedKernel", ...]:
        """The jax kernels behind ``run_iteration_batch``, for the
        bitwise-batchability lint.  Apps setting ``supports_batched_step``
        should expose every batched dispatch here; the lint (and CI) walks
        each kernel's jaxpr for cross-lane reductions."""
        return ()

    def restart_init(self, seed: int, persisted: Mapping[str, np.ndarray]) -> State:
        """Rebuild a runnable state from the (possibly inconsistent) NVM image.

        Default: re-run ``init`` (restores temporaries / read-only objects)
        then overwrite candidates with their persisted images.
        """
        state = self.init(seed)
        for k, v in persisted.items():
            if k in state:
                state[k] = np.array(v, copy=True).astype(state[k].dtype, copy=False)
        return state

    def verify(self, state: State) -> VerifyResult:
        """Application-specific acceptance verification."""
        raise NotImplementedError

    def progress(self, state: State) -> float:
        """Convergence metric (residual / loss); used for early-stop checks."""
        return float("nan")

    # ------------------------------------------------------------------ runner
    def run_iteration(self, state: State) -> State:
        for region in self.regions():
            state = region.fn(state)
        return state

    def run_region(self, state: State, region_idx: int) -> State:
        return self.regions()[region_idx].fn(state)

    def run_to_completion(self, state: State, first_iter: int, max_iters: int) -> Tuple[State, int]:
        """Run the main loop from ``first_iter`` for up to ``max_iters`` total
        iterations (counted across the whole execution).  Returns final state
        and the number of iterations executed in this call."""
        executed = 0
        it = first_iter
        while it < max_iters:
            state = self.run_iteration(state)
            it += 1
            executed += 1
            if self.converged(state, it):
                break
        return state, executed

    def converged(self, state: State, it: int) -> bool:
        """Early termination hook: by default run the fixed iteration count."""
        return it >= self.n_iters

    # ------------------------------------------------------- batched recompute
    # The vectorized campaign engine advances many independent restart lanes
    # at once.  The default implementations loop the serial hooks (always
    # correct); apps that set ``supports_batched_step`` override them with
    # stacked array ops so a whole lane batch costs one dispatch.  Contract
    # for every override: lane i's result is bitwise identical to the serial
    # hook on lane i alone, and exceptions are captured per lane (a blown-up
    # lane classifies as S3 without tearing down its batch-mates).

    def run_iteration_batch(self, states: Sequence[State]) -> "List[State]":
        """Advance each state one main-loop iteration; pure per lane."""
        return [self.run_iteration(s) for s in states]

    def advance_lanes(
        self, states: Sequence[State], its: Sequence[int], stop: int
    ) -> Tuple["List[State]", "List[int]", "List[bool]"]:
        """Jit-resident phase A: run every lane's run-to-completion loop
        (``run_to_completion(state, it, stop)`` — step, increment, break on
        ``converged`` or ``it >= stop``) in as few device dispatches as the
        app can manage, typically one donated-buffer ``lax.while_loop`` via
        :class:`repro.core.lane_driver.JitLaneDriver`.

        Returns ``(states, its, oks)``.  ``oks[i]`` false means the driver
        could not decide lane ``i`` bit-exactly (blow-up, overflow screen);
        the lane comes back **unmodified** and the caller reclassifies it
        through the serial path.  Only consulted when
        ``supports_lane_driver`` is set.
        """
        raise NotImplementedError

    def converged_batch(self, states: Sequence[State], its: Sequence[int]) -> "List[object]":
        """Element i is ``converged(states[i], its[i])`` — a bool, or the
        exception instance the serial hook would have raised (blow-ups)."""
        out: "List[object]" = []
        for s, it in zip(states, its):
            try:
                out.append(bool(self.converged(s, it)))
            except Exception as e:  # noqa: BLE001 - captured per lane
                out.append(e)
        return out

    def verify_batch(self, states: Sequence[State]) -> "List[object]":
        """Element i is ``verify(states[i])`` — a :class:`VerifyResult`, or
        the exception instance the serial hook would have raised."""
        out: "List[object]" = []
        for s in states:
            try:
                out.append(self.verify(s))
            except Exception as e:  # noqa: BLE001 - captured per lane
                out.append(e)
        return out

    def run_golden(self, seed: int = 0) -> Tuple[State, int]:
        state = self.init(seed)
        state, executed = self.run_to_completion(state, 0, self.n_iters)
        return state, executed


def object_blocks(state: State, names: Sequence[str], block_bytes: int) -> Dict[str, int]:
    out = {}
    for n in names:
        arr = np.asarray(state[n])
        out[n] = max(1, -(-arr.nbytes // block_bytes))
    return out
