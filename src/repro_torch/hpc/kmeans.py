# Port of repro/hpc/kmeans.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * The squared distances sum over the dimensions one at a time, each term
#   added by torch.addcmul (one rounding): that is the order and the
#   contraction XLA gives ``sum((p - c) ** 2, axis=-1)`` on the CPU, so the
#   distances, and the assignment, are bitwise JAX's.  It also holds the
#   temporary to (n, k) per term instead of (n, k, d).
# * argmin takes the first minimum, as jnp.argmin does.
# * The update's one-hot product is a plain torch.matmul per lane (no bmm),
#   and the inertia's sum is common.tree_sum: both agree with JAX's to about
#   1e-6 relative (other summation orders), and each lane is bitwise the
#   serial one.  counts are sums of ones, exact in any order.
# * No lane driver (supports_lane_driver stays False; ROADMAP, module item 5).
"""k-means (Rodinia analogue, data mining).

Two regions: assignment and centroid update.  The points are read-only; the
only main-loop data object is the centroid table — the paper's extreme case
("critical DO size: 20 B"): persisting a tiny object transforms
recomputability (+93 % in the paper) at essentially zero cost.

Acceptance verification: final inertia within a tolerance band of the golden
run (a fidelity-threshold acceptance per §2.2, not bitwise equality).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .common import as_numpy, as_tensor, tree_sum


def _sq_dist(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, summed over the dimensions in order."""
    d2 = torch.zeros((points.shape[0], centroids.shape[0]), dtype=points.dtype,
                     device=points.device)
    for j in range(points.shape[1]):
        diff = points[:, j, None] - centroids[None, :, j]
        d2 = torch.addcmul(d2, diff, diff)
    return d2


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return torch.argmin(_sq_dist(points, centroids), dim=1).to(torch.int32)


def _update(points: torch.Tensor, assign: torch.Tensor, centroids: torch.Tensor,
            k: int) -> torch.Tensor:
    one_hot = torch.nn.functional.one_hot(assign.long(), k).to(points.dtype)  # (n, k)
    sums = torch.matmul(one_hot.t(), points)                                 # (k, d)
    counts = one_hot.sum(dim=0)[:, None]                                     # (k, 1)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centroids)


def _inertia(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return tree_sum(_sq_dist(points, centroids).amin(dim=1))


class KMeansApp(IterativeApp):
    name = "kmeans"
    candidates = ("centroids", "k")

    def __init__(self, n_points: int = 4000, n_dims: int = 8, n_clusters: int = 12,
                 n_iters: int = 40, seed: int = 0, inertia_tol: float = 1.01,
                 cluster_scale: float = 3.0, device: str = "cuda"):
        self.cluster_scale = cluster_scale
        self.n_points = n_points
        self.n_dims = n_dims
        self.n_clusters = n_clusters
        self.n_iters = n_iters
        self._seed = seed
        self.inertia_tol = inertia_tol
        self.device = resolve_device(device)
        self._golden_inertia: float | None = None

    def init(self, seed: int = 0) -> State:
        rng = np.random.default_rng(self._seed)
        # moderately-separated clusters: losing the centroids can strand the
        # restart in a different local optimum (strict inertia acceptance)
        true_c = rng.standard_normal((self.n_clusters, self.n_dims)).astype(np.float32) * self.cluster_scale
        labels = rng.integers(0, self.n_clusters, self.n_points)
        points = (true_c[labels] + rng.standard_normal((self.n_points, self.n_dims))).astype(np.float32)
        init_c = points[rng.choice(self.n_points, self.n_clusters, replace=False)].copy()
        return {
            "points": points,                       # read-only
            "centroids": init_c,
            "assign": np.zeros(self.n_points, np.int32),  # temporal
            "k": np.zeros(1, np.int64),
        }

    def _t(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _region_assign(self, s: State) -> State:
        s = dict(s)
        s["assign"] = self._like(_assign(self._t(s["points"]), self._t(s["centroids"])),
                                 s["assign"])
        return s

    def _region_update(self, s: State) -> State:
        s = dict(s)
        s["centroids"] = self._like(
            _update(self._t(s["points"]), self._t(s["assign"]), self._t(s["centroids"]),
                    self.n_clusters), s["centroids"])
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("assign", self._region_assign, writes=("assign",),
                   reads=("points", "centroids"), cost=4.0,
                   hot_reads=("centroids",)),
            Region("update", self._region_update, writes=("centroids", "k"),
                   reads=("points", "assign"), cost=1.0,
                   hot_reads=("centroids",)),
        )

    def _inertia_of(self, state: State) -> float:
        return float(_inertia(self._t(state["points"]), self._t(state["centroids"])))

    def _golden_target(self) -> float:
        if self._golden_inertia is None:
            s = self.init(self._seed)
            for _ in range(self.n_iters):
                s = self.run_iteration(s)
            self._golden_inertia = self._inertia_of(s)
        return self._golden_inertia

    def _accept(self, inertia: float) -> VerifyResult:
        ok = np.isfinite(inertia) and inertia <= self._golden_target() * self.inertia_tol
        return VerifyResult(bool(ok), inertia)

    def verify(self, state: State) -> VerifyResult:
        return self._accept(self._inertia_of(state))

    def progress(self, state: State) -> float:
        return self._inertia_of(state)

    # ------------------------------------------------------- batched recompute
    # ``points`` is read-only and never a candidate, so every restart lane
    # carries the identical init-rebuilt array; the hooks stack only the
    # centroid tables, take lane 0's points and run the serial functions
    # one lane at a time (the products and sums as the serial path does them).
    supports_batched_step = True

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        pts = self._t(s["points"])
        c3 = self._t(np.stack([s["centroids"]] * 3))
        k = self.n_clusters

        def step_batch(cb):
            assign = [_assign(pts, c) for c in cb]
            return (torch.stack(assign),
                    torch.stack([_update(pts, a, c, k) for a, c in zip(assign, cb)]))

        return (
            BatchedKernel("step_batch", step_batch, (c3,), {0: 0}),
            BatchedKernel("inertia_batch", lambda cb: torch.stack([_inertia(pts, c) for c in cb]),
                          (c3,), {0: 0}),
        )

    def run_iteration_batch(self, states):
        pts = self._t(as_numpy(states[0]["points"]))
        out = []
        for s in states:
            c = self._t(as_numpy(s["centroids"]))
            a = _assign(pts, c)
            s = dict(s)
            s["assign"] = as_numpy(a)
            s["centroids"] = as_numpy(_update(pts, a, c, self.n_clusters))
            s["k"] = s["k"] + 1
            out.append(s)
        return out

    # converged() is a pure iteration counter — the looping default is free

    def verify_batch(self, states):
        pts = self._t(as_numpy(states[0]["points"]))
        return [self._accept(float(_inertia(pts, self._t(as_numpy(s["centroids"])))))
                for s in states]
