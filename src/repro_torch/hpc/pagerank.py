# Port of repro/hpc/pagerank.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * The spmv is torch.mv of the dense link matrix (a plain product, TF32 off:
#   device.resolve_device); its sums have the BLAS's order, not XLA's, so
#   y agrees with JAX's to about 1e-6 relative.  The rank vector is copied
#   to a fresh allocation first, so the product never depends on where a
#   lane's row sits in a stack (a BLAS may take another path for another
#   alignment).
# * _damped rounds once, as XLA contracts ``damping * y + c`` into one
#   fused multiply-add: torch.addcmul(c, y, damping) gives JAX's bits.  The
#   residual sum is common.tree_sum (to about 1e-6 of JAX's).
# * Batched lanes run the serial spmv one lane at a time (no bmm, no
#   batched matmul: another reduction tiling), and the damped update on the
#   stack (elementwise, and a per-row tree_sum).
# * advance_lanes runs core/lane_driver.py's device loop over _step_core,
#   the tensor core of run_iteration_batch (a CUDA graph on the card).
"""PageRank: damped power iteration on a random directed graph.

Analogue of an irregular graph-analytics workload (the paper's spectrum
beyond the NPB kernels).  The link matrix is column-stochastic and dense at
suite sizes; one main-loop iteration is spmv -> damped apply -> bookkeeping.
The rank vector is re-read continuously while the matvec streams the link
matrix, so it is *hot* in the NVCT cache model — like the k-means centroid
table, it tends to stay chronically dirty and leave only ancient values in
NVM (paper §8), which is exactly what makes it a critical data object.

Power iteration contracts at the damping factor per step, so early crashes
recompute for free while late crashes lack the remaining iterations to
re-absorb a stale rank vector (S2 territory).

Acceptance verification: fixed-point residual ||G(rank) - rank||_1 below
tolerance, where G is the damped update (math-invariant check, §2.2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .common import as_numpy, as_tensor, tree_sum


def _spmv(links: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """links @ rank for one lane, on a fresh copy of ``rank``."""
    return torch.mv(links, rank.clone())


def _damped(y: torch.Tensor, rank: torch.Tensor, damping: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(damping * y + (1 - damping) / n, sum |new - rank|); leading
    dimensions are lanes."""
    n = rank.shape[-1]
    # jit passes the Python float as a float32 operand, and computes the
    # constant term in float32 from it (fills, not host copies: the lane
    # driver's CUDA graph captures them)
    d = torch.full((), float(np.float32(damping)), dtype=y.dtype, device=y.device)
    c = (1.0 - d) / torch.full((), float(n), dtype=y.dtype, device=y.device)
    new = torch.addcmul(c.expand_as(y), y, d)
    return new, tree_sum((new - rank).abs())


def _step_core(links: torch.Tensor, rank_b: torch.Tensor, damping: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One iteration on stacked lanes: (y, new rank, delta (L,)); the spmv
    one lane at a time, the damped update on the stack."""
    y_b = torch.stack([_spmv(links, r) for r in rank_b])
    new_b, deltas = _damped(y_b, rank_b, damping)
    return y_b, new_b, deltas


class PageRankApp(IterativeApp):
    name = "pagerank"
    candidates = ("rank", "y", "k")
    #: campaign fault tuning: the rank vector is chronically cached (hot in
    #: the spmv), so NVM holds ancient rank data — silent bit flips there are
    #: the interesting SDC surface, and correlated failures should strike the
    #: dominant spmv region.
    fault_defaults = {
        "bit-flip": {"n_bits": 16},
        "correlated-region": {"shape": 3.0},
    }

    def __init__(self, n_nodes: int = 256, out_degree: int = 3, damping: float = 0.9,
                 tol: float = 1e-5, n_iters: int = 100, seed: int = 0,
                 device: str = "cuda"):
        self.n_nodes = n_nodes
        self.out_degree = out_degree
        self.damping = damping
        self.tol = tol
        self.n_iters = n_iters
        self._seed = seed
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> State:
        n = self.n_nodes
        rng = np.random.default_rng(self._seed)
        links = np.zeros((n, n), np.float32)
        for j in range(n):
            targets = rng.choice(n, size=self.out_degree, replace=False)
            links[targets, j] = 1.0 / self.out_degree
        return {
            "links": links,                          # read-only
            "rank": np.full(n, 1.0 / n, np.float32),
            "y": np.zeros(n, np.float32),            # temporal
            "delta": np.zeros(1, np.float32),        # temporal diagnostic
            "k": np.zeros(1, np.int64),
        }

    def _t(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _region_spmv(self, s: State) -> State:
        s = dict(s)
        s["y"] = self._like(_spmv(self._t(s["links"]), self._t(s["rank"])), s["y"])
        return s

    def _region_apply(self, s: State) -> State:
        s = dict(s)
        new, delta = _damped(self._t(s["y"]), self._t(s["rank"]), self.damping)
        s["rank"] = self._like(new, s["rank"])
        s["delta"] = self._like(delta.reshape(1), s["delta"])
        return s

    def _region_book(self, s: State) -> State:
        s = dict(s)
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("spmv", self._region_spmv, writes=("y",),
                   reads=("links", "rank"), cost=4.0, hot_reads=("rank",)),
            Region("apply", self._region_apply, writes=("rank", "delta"),
                   reads=("y", "rank"), cost=1.0),
            Region("book", self._region_book, writes=("k",), cost=0.1),
        )

    def _residual_of(self, y: np.ndarray, rank: np.ndarray) -> float:
        # numpy on the host, as the JAX app computes it
        target = self.damping * y + (1.0 - self.damping) / self.n_nodes
        return float(np.abs(target - rank).sum())

    def _fixed_point_residual(self, state: State) -> float:
        y = as_numpy(_spmv(self._t(state["links"]), self._t(state["rank"])))
        return self._residual_of(y, as_numpy(state["rank"]))

    def verify(self, state: State) -> VerifyResult:
        r = self._fixed_point_residual(state)
        return VerifyResult(bool(np.isfinite(r) and r < self.tol), r)

    def progress(self, state: State) -> float:
        return self._fixed_point_residual(state)

    def converged(self, state: State, it: int) -> bool:
        if it >= self.n_iters:
            return True
        delta = float(state["delta"][0])
        if not np.isfinite(delta):
            raise FloatingPointError("pagerank blow-up")
        # delta is ||G(rank_prev) - rank_prev||_1's damped successor; the
        # true fixed-point residual is only asserted by verify()
        return 0 < delta < self.tol * 0.5

    # ------------------------------------------------------- batched recompute
    # ``links`` is read-only and never a selection candidate, so every
    # restart lane carries the identical init-rebuilt matrix — the batched
    # hooks stack only the per-lane vectors and take lane 0's links.
    supports_batched_step = True
    supports_lane_driver = True

    def _spmv_batch(self, links: torch.Tensor, rank_b: torch.Tensor) -> torch.Tensor:
        return torch.stack([_spmv(links, r) for r in rank_b])

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        links = self._t(s["links"])
        r3 = self._t(np.stack([s["rank"]] * 3))
        y3 = self._t(np.stack([s["y"]] * 3))
        d = self.damping
        return (
            BatchedKernel("spmv_batch", lambda rb: self._spmv_batch(links, rb), (r3,), {0: 0}),
            BatchedKernel("damped_batch", lambda yb, rb: _damped(yb, rb, d),
                          (y3, r3), {0: 0, 1: 0}),
        )

    def run_iteration_batch(self, states):
        rank_b = self._t(np.stack([as_numpy(s["rank"]) for s in states]))
        y_b, new_b, deltas = _step_core(self._t(as_numpy(states[0]["links"])), rank_b,
                                        self.damping)
        y_b, new_b, deltas = as_numpy(y_b), as_numpy(new_b), as_numpy(deltas)
        out = []
        for i, s in enumerate(states):
            s = dict(s)
            s["y"] = y_b[i]
            s["rank"] = new_b[i]
            s["delta"] = deltas[i].reshape(1).astype(np.float32)
            s["k"] = s["k"] + 1
            out.append(s)
        return out

    # converged() only reads the scalar delta — the looping default is fine

    def verify_batch(self, states):
        rank_rows = np.stack([as_numpy(s["rank"]) for s in states])
        y_rows = as_numpy(self._spmv_batch(self._t(as_numpy(states[0]["links"])),
                                           self._t(rank_rows)))
        out = []
        for i in range(len(states)):
            r = self._residual_of(y_rows[i], rank_rows[i])
            out.append(VerifyResult(bool(np.isfinite(r) and r < self.tol), r))
        return out

    def advance_lanes(self, states, its, stop):
        from ..core.lane_driver import LaneSpec, cached_driver, f32_monotone_cutoff

        d, n_iters = self.damping, self.n_iters
        # the serial decision 0 < delta < tol/2 is a monotone float64
        # predicate of the carried float32 delta, so it folds to an exact
        # device comparison against the cutoff
        cutoff = float(f32_monotone_cutoff(lambda v: v < self.tol * 0.5))

        def step(consts, a):
            y, new, delta = _step_core(consts["links"], a["rank"], d)
            return {"rank": new, "y": y, "delta": delta[:, None], "k": a["k"] + 1}

        def check(consts, a, it):
            dl = a["delta"][:, 0]
            over = it >= n_iters
            fin = torch.isfinite(dl)
            conv = over | (fin & (dl > 0) & (dl <= cutoff))
            suspect = ~over & ~fin  # serial converged() would raise
            return conv, suspect

        key = ("pagerank", self.n_nodes, self.out_degree, d, self.tol, n_iters, self._seed,
               self.device)
        drv = cached_driver(key, lambda: LaneSpec(
            carry=("rank", "y", "delta", "k"),
            consts=lambda s0: {"links": self._t(as_numpy(s0["links"]))},
            step=step, check=check, device=self.device,
        ))
        return drv.advance(states, its, stop)
