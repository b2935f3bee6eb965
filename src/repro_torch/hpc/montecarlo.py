# Port of repro/hpc/montecarlo.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * The Gaussian pairs come from hpc/threefry.py, the port's copy of JAX's
#   threefry stream: the same keys (fold_in(PRNGKey(1234), k)) and bits,
#   and normals within a few ulp of JAX's.  A round is drawn in pieces of
#   _PIECE pairs, which bounds the working memory at any batch and gives
#   the same values as one draw.
# * Two roundings of x*x + y*y, as in JAX: the tally path takes the in-jit
#   contraction fma(y, y, x*x) (torch.addcmul), the scratch path eager's
#   separate roundings.  The tallies equal _tally_batch's, and the golden
#   counts the JAX app's.
# * The tally is torch.bincount, an exact integer count in any order.
# * The scratch sum is common.tree_sum (one fixed order: lanes bitwise, the
#   card's sum the CPU's), added in float64 to ``sums`` in the serial order.
#   It is not np.sum's, so ``sums[1]`` is not JAX's to the bit;
#   verification reads ``counts`` only.
# * advance_lanes stays bespoke, as in JAX: the rounds depend only on k, so
#   it draws each round of [min(its), stop) once on the device and replays
#   every lane's accumulation on the host.  It takes no CUDA graph
#   (bincount reads its size back).
"""EP analogue: embarrassingly-parallel Monte Carlo tally (NPB EP).

Each iteration generates a deterministic batch of Gaussian pairs (counter-
based RNG keyed by the iteration index) and *accumulates* annulus counts.
Acceptance verification demands an **exact** match with the golden tallies —
EP's verification in the paper is numerically precise, and accumulation is
not idempotent across a mid-iteration restart, so recomputability is ~0 even
with persistence (paper §6: "we do not present results for EP, because its
inherent recomputability is 0").  This app is the suite's negative control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from . import threefry
from .common import as_numpy, as_tensor, tree_sum

_BASE_KEY = threefry.prng_key(1234)
#: pairs drawn at once (2**22 pairs: 32 MiB of int64 per threefry word)
_PIECE = 1 << 22


def _round(k, batch: int, nbins: int, device: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round ``k``'s (tally int64 (nbins,), scratch rad2 float32 (batch,));
    ``k`` is an int or a 0-d integer tensor on ``device`` (the same bits)."""
    key = threefry.fold_in(_BASE_KEY, k)
    tally = torch.zeros(nbins, dtype=torch.int64, device=device)
    scratch = torch.empty(batch, dtype=torch.float32, device=device)
    for lo in range(0, batch, _PIECE):
        n = min(_PIECE, batch - lo)
        xy = threefry.normal(key, (n, 2), device, offset=2 * lo)
        x, y = xy[:, 0], xy[:, 1]
        rad2 = torch.addcmul(x * x, y, y)
        bins = torch.clamp(threefry.sqrt_f32(rad2).to(torch.int32), 0, nbins - 1)
        tally += torch.bincount(bins, minlength=nbins)
        scratch[lo:lo + n] = tree_sum(xy * xy)
    return tally, scratch


def _mc_rounds(ks: torch.Tensor, batch: int, nbins: int, device: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each lane's round of ``ks`` (an integer tensor (L,)): tallies (L,
    nbins) and scratch (L, batch), one lane at a time, each bitwise
    ``_round`` of that lane's k (the loop over lanes is lax.map's form)."""
    rounds = [_round(k, batch, nbins, device) for k in ks]
    return torch.stack([t for t, _ in rounds]), torch.stack([s for _, s in rounds])


class MonteCarloApp(IterativeApp):
    name = "montecarlo"
    candidates = ("counts", "sums", "k")

    def static_hints(self):
        # the tally regions are host-side (untraceable), but the algorithm
        # fact is declarative: verification is an exact golden match and the
        # tallies accumulate, so a replayed iteration double-counts
        return {"counts": "exact-accumulator", "sums": "exact-accumulator"}

    def __init__(self, batch: int = 8192, nbins: int = 10, n_iters: int = 24, seed: int = 0,
                 device: str = "cuda"):
        self.batch = batch
        self.nbins = nbins
        self.n_iters = n_iters
        self._seed = seed
        self.device = resolve_device(device)
        self._golden_counts: np.ndarray | None = None

    def init(self, seed: int = 0) -> State:
        return {
            "counts": np.zeros(self.nbins, np.int64),
            "sums": np.zeros(2, np.float64),
            "scratch": np.zeros(self.batch, np.float32),  # temporal work array
            "k": np.zeros(1, np.int64),
        }

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _generate(self, s: State) -> State:
        s = dict(s)
        _, scratch = _round(int(s["k"][0]), self.batch, self.nbins, self.device)
        s["scratch"] = self._like(scratch, s["scratch"])
        return s

    def _accumulate(self, s: State) -> State:
        s = dict(s)
        tal, _ = _round(int(s["k"][0]), self.batch, self.nbins, self.device)
        ssum = tree_sum(as_tensor(s["scratch"], self.device))
        if isinstance(s["counts"], torch.Tensor):
            s["counts"] = s["counts"] + tal
            s["sums"] = s["sums"] + torch.stack([tal.sum().double(), ssum.double()])
        else:
            tal = as_numpy(tal)
            s["counts"] = s["counts"] + tal
            s["sums"] = s["sums"] + np.array([tal.sum(), float(ssum)])
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("generate", self._generate, writes=("scratch",), reads=("k",), cost=3.0),
            Region("accumulate", self._accumulate, writes=("counts", "sums", "k"),
                   reads=("scratch", "counts", "sums"), cost=1.0),
        )

    def _golden(self) -> np.ndarray:
        if self._golden_counts is None:
            s = self.init(self._seed)
            for _ in range(self.n_iters):
                s = self.run_iteration(s)
            self._golden_counts = s["counts"].copy()
        return self._golden_counts

    def verify(self, state: State) -> VerifyResult:
        counts = as_numpy(state["counts"])
        ok = np.array_equal(counts, self._golden())
        return VerifyResult(bool(ok), float(np.abs(counts - self._golden()).sum()))

    def progress(self, state: State) -> float:
        return float(as_numpy(state["counts"]).sum())

    # ------------------------------------------------------- batched recompute
    # converged() is the counter default and verify() is a pure host compare,
    # so only the round generation is batched; accumulation stays host-side.
    supports_batched_step = True
    supports_lane_driver = True

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        batch, nbins, device = self.batch, self.nbins, self.device
        ks = torch.arange(3, dtype=torch.int32, device=device)
        return (
            BatchedKernel("mc_rounds", lambda kv: _mc_rounds(kv, batch, nbins, device),
                          (ks,), {0: 0}),
        )

    def _rounds(self, ks) -> Dict[int, Tuple[np.ndarray, np.ndarray, float]]:
        """Each distinct round of ``ks`` once: k -> (tally, scratch, its
        tree_sum as a float)."""
        out = {}
        for k in sorted(set(int(k) for k in ks)):
            tal, scratch = _round(k, self.batch, self.nbins, self.device)
            out[k] = (as_numpy(tal), as_numpy(scratch), float(tree_sum(scratch)))
        return out

    @staticmethod
    def _apply_round(s: State, rnd: Tuple[np.ndarray, np.ndarray, float]) -> State:
        """One iteration from precomputed round data, in exact serial order:
        scratch, counts, then the float64 [n, sum(rad2)] pair, then k."""
        tal, scratch, ssum = rnd
        s = dict(s)
        s["scratch"] = scratch.copy()
        s["counts"] = s["counts"] + tal
        s["sums"] = s["sums"] + np.array([tal.sum(), ssum])
        s["k"] = s["k"] + 1
        return s

    def run_iteration_batch(self, states):
        rounds = self._rounds(int(s["k"][0]) for s in states)
        return [self._apply_round(s, rounds[int(s["k"][0])]) for s in states]

    def advance_lanes(self, states, its, stop):
        """Bespoke phase A: the loop has no data recurrence (the round
        stream depends only on k), so every round in [min(its), stop) is
        drawn once and the host replays each lane's accumulation bitwise."""
        stop = int(stop)
        # the generate region is keyed by the state's own k; the replay
        # assumes k == it (the campaign bookmarks the iterator to the restart
        # iteration, so this always holds — guard anyway)
        oks = [int(s["k"][0]) == int(it) for s, it in zip(states, its)]
        todo = [i for i, ok in enumerate(oks) if ok and its[i] < stop]
        out_states = list(states)
        out_its = [int(it) for it in its]
        if todo:
            rounds = self._rounds(range(min(int(its[i]) for i in todo), stop))
            for i in todo:
                s = states[i]
                for t in range(int(its[i]), stop):
                    s = self._apply_round(s, rounds[t])
                out_states[i] = s
                out_its[i] = stop
        return out_states, out_its, oks
