# Port copy of repro/core/faults.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Pluggable fault models for crash campaigns.

The paper's NVCT draws exactly one failure flavor: a clean power failure at a
uniformly random crash point, with every cacheline image perfectly atomic —
a block either reached NVM in full or not at all.  The S1–S4 outcome taxonomy
(§3–4), however, absorbs a much wider family of failures, and the
recomputability numbers shift materially with the failure model.  This module
makes the failure model a first-class, pluggable campaign parameter.

Models and the paper scenario each stresses:

========================  ====================================================
model                     scenario / outcome classes stressed
========================  ====================================================
``PowerFail``             the paper's §3 baseline: clean power-fail, atomic
                          cachelines, uniform crash point.  Default; campaigns
                          reproduce the historical engine bit-for-bit.
``TornWrite``             the in-flight write sweep's recently stored
                          cachelines land *partially* in NVM (per-block
                          Bernoulli tearing of the store queue).  Stresses the
                          §4 data-inconsistency analysis: images mix bytes of
                          two versions inside one block, pushing records
                          toward S2/S3.
``MultiCrash``            a second crash strikes while the recomputation is
                          still running, forcing recovery-from-recovery (the
                          paper's §7 efficiency model assumes recovery always
                          completes; this measures what happens when it does
                          not).  Stresses S2 (extra iterations compound) and
                          S4 (budget exhaustion).
``BitFlip``               silent data corruption: after the NVM image is
                          formed, k bits flip in non-persisted objects,
                          modeling undetected media/controller corruption.
                          The §3 taxonomy absorbs this as S3 (blow-up /
                          interruption) or S4 (acceptance never reached) —
                          or, for contraction-dominated solvers, S1/S2.
``CorrelatedRegion``      crash points are not uniform: failures concentrate
                          in the *heaviest* code region (utilization-
                          correlated failure, Weibull-ish weighting of region
                          residency).  Stresses the §5.2 per-region
                          recomputability c_k estimates, which the uniform
                          draw samples evenly.
========================  ====================================================

Determinism contract (all models): every random decision is derived either
from the campaign RNG at *planning* time (crash points) or from the per-test
``fault_seed`` pre-drawn at planning time (tearing, bit flips, recovery
crashes).  Nothing depends on execution order, so campaigns are bit-for-bit
identical across ``n_workers`` and across a kill/resume through
:class:`~repro.core.campaign_store.CampaignStore`.  The store fingerprint
includes :meth:`FaultModel.spec`, so a resumed store refuses a different
fault model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from .cache_sim import TornBlock, WindowTrace

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .crash_tester import CrashTester, PlannedTest

#: stream-splitting salt so per-test fault RNG never collides with the
#: campaign planning RNG (which is seeded with the bare campaign seed)
_FAULT_STREAM = 0xEC_FA17

#: salts for the independent per-test decision streams
_SALT_TEAR = 1
_SALT_FLIP = 2
_SALT_RECOVERY = 3


def _test_rng(test: "PlannedTest", salt: int) -> np.random.Generator:
    """Per-test decision stream: depends only on the pre-drawn fault seed
    (and the decision kind), never on execution order."""
    return np.random.default_rng((_FAULT_STREAM, int(test.fault_seed), salt))


@dataclass(frozen=True)
class FaultModel:
    """Base fault model == the paper's clean power failure.

    Subclasses override one or more hooks; every hook must be a pure function
    of its arguments (plus frozen model parameters), with randomness drawn
    only from the planning RNG or the per-test ``fault_seed`` stream.
    """

    #: registry key; also the ``--fault-model`` spelling in CLIs
    model_name = "power-fail"
    #: whether :meth:`CrashTester.plan_campaign` pre-draws a per-test fault
    #: seed.  False for the default model keeps the historical campaign RNG
    #: stream untouched (PowerFail is bit-for-bit the PR-1 engine).
    uses_test_entropy = False

    # ----------------------------------------------------------- fingerprint
    def spec(self) -> Dict[str, object]:
        """JSON-round-trippable identity, stored in campaign fingerprints."""
        out: Dict[str, object] = {"model": self.model_name}
        for f in getattr(self, "__dataclass_fields__", {}):
            v = getattr(self, f)
            out[f] = float(v) if isinstance(v, float) else int(v) if isinstance(v, (int, np.integer)) else v
        return out

    # -------------------------------------------------------- planning hook
    def draw_crash_point(self, rng: np.random.Generator, planner: "CrashTester") -> Tuple[int, int]:
        """Draw ``(crash_iter, crash_t)`` with the campaign RNG.

        The default performs exactly the historical two draws (uniform crash
        iteration, then uniform time inside the iteration's window), in the
        historical order — this is what keeps ``PowerFail`` campaigns
        bit-for-bit identical to the pre-fault-model engine.
        """
        crash_iter = int(rng.integers(0, planner.golden_iters))
        t_lo, t_end = planner.window_bounds(crash_iter)
        return crash_iter, int(rng.integers(t_lo, t_end))

    # ------------------------------------------------------ resolution hook
    def torn_blocks(
        self, test: "PlannedTest", trace: WindowTrace, block_bytes: int
    ) -> Optional[List[TornBlock]]:
        """Cachelines of the in-flight sweep that land partially in NVM
        (``None`` == atomic cachelines, the default)."""
        return None

    # ----------------------------------------------------------- image hook
    def corrupt_image(
        self,
        test: "PlannedTest",
        image: Dict[str, np.ndarray],
        protected: Sequence[str],
    ) -> Dict[str, np.ndarray]:
        """Post-process the resolved NVM image (SDC injection point).

        ``protected`` lists objects the model must not touch (the persist
        plan's flushed objects and the bookmarked loop iterator).
        """
        return image

    # -------------------------------------------------------- recovery hook
    def recovery_plan(
        self, test: "PlannedTest", restart_iter: int, golden_iters: int
    ) -> Optional[Tuple[int, float]]:
        """Second crash during recompute: ``(recrash_iter, u)`` where
        ``recrash_iter`` is the iteration the second crash strikes in and
        ``u`` in [0, 1) places the crash time inside that iteration's window.
        ``None`` == recovery runs undisturbed (the default)."""
        return None


@dataclass(frozen=True)
class PowerFail(FaultModel):
    """The paper's baseline: clean power-fail, atomic cachelines, uniform
    crash point.  All hooks are the base-class defaults."""

    model_name = "power-fail"


@dataclass(frozen=True)
class TornWrite(FaultModel):
    """Torn cacheline writes at the crash point.

    The cache model treats a crash as atomic at block granularity; real
    persistence domains drain a store queue, and a power cut mid-drain leaves
    *partial* cachelines.  For the sweep in flight at the crash, each of its
    last ``depth`` stored blocks independently tears with probability
    ``p_torn``: a prefix of 1..block_bytes-1 bytes of the new version lands
    in NVM, the suffix keeps whatever NVM held.
    """

    model_name = "torn-write"
    uses_test_entropy = True

    p_torn: float = 0.5
    depth: int = 8

    def torn_blocks(self, test, trace, block_bytes):
        # Sweeps are time-disjoint and ordered, so at most one — the last
        # with t_start < crash_t — can be in flight; find it with one binary
        # search over the trace's SoA sweep arrays instead of a Python scan.
        # Only in-flight sweeps ever consumed tearing entropy, so the rng
        # stream is bit-for-bit the historical per-sweep loop's.
        ct = int(test.crash_t)
        t_starts, _ = trace.sweep_soa()
        idx = int(np.searchsorted(t_starts, ct, side="left")) - 1
        if idx < 0:
            return None
        sw = trace.sweeps[idx]
        done = ct - sw.t_start
        if done >= sw.n_blocks:
            return None  # sweep completed before the crash: stores drained
        rng = _test_rng(test, _SALT_TEAR)
        out: List[TornBlock] = []
        for blk in range(max(0, done - self.depth), done):
            if rng.random() < self.p_torn:
                cut = int(rng.integers(1, block_bytes))
                out.append(TornBlock(sw.obj, blk, cut, sw.seq))
        return out or None


@dataclass(frozen=True)
class MultiCrash(FaultModel):
    """A second crash strikes during recomputation.

    With probability ``p_recrash`` the recompute run from the first crash's
    image is itself crashed, at a uniformly drawn iteration of the remaining
    recompute span; the engine simulates a fresh crash window on the *live
    recompute trajectory*, resolves its NVM image, and restarts again
    (recovery-from-recovery).  The second window starts cache-consistent and
    carries no chronic base — the recompute trajectory is not in the
    steady-state regime the chronic adjustment models.
    """

    model_name = "multi-crash"
    uses_test_entropy = True

    p_recrash: float = 1.0

    def recovery_plan(self, test, restart_iter, golden_iters):
        rng = _test_rng(test, _SALT_RECOVERY)
        if rng.random() >= self.p_recrash:
            return None
        if restart_iter >= golden_iters:
            return None
        recrash_iter = int(rng.integers(restart_iter, golden_iters))
        return recrash_iter, float(rng.random())


@dataclass(frozen=True)
class BitFlip(FaultModel):
    """Silent data corruption in the NVM image.

    After the crash image is resolved (and before restart), ``n_bits``
    distinct bits flip across the *non-persisted* objects — corruption the
    flush path never scrubbed and no checksum catches.  Flushed objects and
    the bookmarked loop iterator are protected; if every candidate is
    flushed, the image is returned untouched (the model has nothing
    unprotected to corrupt).
    """

    model_name = "bit-flip"
    uses_test_entropy = True

    n_bits: int = 8

    def corrupt_image(self, test, image, protected):
        targets = [o for o in sorted(image) if o not in protected]
        sizes = [int(np.asarray(image[o]).nbytes) for o in targets]
        total_bits = 8 * sum(sizes)
        if total_bits == 0:
            return image
        rng = _test_rng(test, _SALT_FLIP)
        k = min(self.n_bits, total_bits)
        positions = rng.choice(total_bits, size=k, replace=False)
        out = dict(image)
        flat: Dict[str, np.ndarray] = {}
        offsets = np.cumsum([0] + [8 * s for s in sizes])
        for pos in sorted(int(p) for p in positions):
            oi = int(np.searchsorted(offsets, pos, side="right")) - 1
            obj = targets[oi]
            if obj not in flat:
                arr = np.ascontiguousarray(np.asarray(out[obj])).copy()
                flat[obj] = arr.view(np.uint8).reshape(-1)
                out[obj] = flat[obj].view(arr.dtype).reshape(arr.shape)
            local = pos - int(offsets[oi])
            flat[obj][local // 8] ^= np.uint8(1 << (local % 8))
        return out


@dataclass(frozen=True)
class CorrelatedRegion(FaultModel):
    """Utilization-correlated crash points.

    The crash iteration stays uniform, but within the iteration the crash
    region is drawn with probability proportional to (region access time)
    ** ``shape`` — a Weibull-ish concentration on the heaviest region
    (``shape=1`` recovers residency-proportional sampling, which is what the
    uniform time draw already does; larger shapes model failures that strike
    under peak load).  The crash time is then uniform inside the chosen
    region's span.
    """

    model_name = "correlated-region"
    uses_test_entropy = False

    shape: float = 3.0

    def draw_crash_point(self, rng, planner):
        crash_iter = int(rng.integers(0, planner.golden_iters))
        t_lo, _ = planner.window_bounds(crash_iter)
        spans = planner.region_time_spans()
        w = np.array([max(t1 - t0, 0) for t0, t1 in spans], dtype=np.float64)
        w = np.where(w > 0, w, 1e-9) ** self.shape
        ridx = int(rng.choice(len(spans), p=w / w.sum()))
        t0, t1 = spans[ridx]
        if t1 <= t0:
            return crash_iter, int(t_lo + t0)
        return crash_iter, int(t_lo + rng.integers(t0, t1))


#: registry, keyed by the CLI spelling
FAULT_MODELS: Dict[str, Type[FaultModel]] = {
    cls.model_name: cls
    for cls in (PowerFail, TornWrite, MultiCrash, BitFlip, CorrelatedRegion)
}


def get_fault_model(name: str, app=None, **overrides) -> FaultModel:
    """Instantiate a registered model, layering parameters as
    model defaults < ``app.fault_defaults[name]`` < explicit ``overrides``."""
    try:
        cls = FAULT_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown fault model {name!r}; have {sorted(FAULT_MODELS)}"
        ) from None
    params: Dict[str, object] = {}
    if app is not None:
        params.update(getattr(app, "fault_defaults", {}).get(name, {}))
    params.update(overrides)
    return cls(**params)


def all_fault_models(app=None) -> Dict[str, FaultModel]:
    """Every registered model, instantiated with ``app``'s
    ``fault_defaults`` applied — the sweep and robustness-matrix benchmarks'
    canonical way to enumerate failure flavors."""
    return {name: get_fault_model(name, app=app) for name in sorted(FAULT_MODELS)}


def fault_model_from_spec(spec: Mapping[str, object]) -> FaultModel:
    """Inverse of :meth:`FaultModel.spec` (e.g. to rehydrate from a store
    header or a plan artifact)."""
    d = dict(spec)
    name = str(d.pop("model"))
    return get_fault_model(name, **d)
