# Port of repro/hpc/cg.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * _dot is common.tree_sum of the products, the port's one fixed reduction
#   order: JAX's jnp.sum has XLA's order, which torch cannot reproduce, so
#   the dots agree with JAX's to about 1e-6 relative, not to the bit.  The
#   fixed order is what makes a batched lane's dots bitwise the serial
#   ones, and the card's the CPU's.
# * The scalar math stays on the host in float64, as in the JAX regions;
#   the axpy updates are a separate multiply and add (eager ops, each
#   rounded), which is what NumPy does in the JAX regions, so given the same
#   scalars they are bitwise JAX's.  The Python float scalar takes the
#   vector's float32 type first, as NumPy's weak scalar does.
# * The batched hook does the same host scalar math per lane (so it needs
#   no f32-division argument) and selects, per lane, between the true
#   residual and the recurrence on residual-replacement iterations.
# * No lane driver (supports_lane_driver stays False; ROADMAP, module item 5).
"""CG: preconditioner-free conjugate gradient on the 2-D Laplacian.

Analogue of NPB CG (sparse linear algebra).  Four first-level code regions
per main-loop iteration — matvec, x-update, r-update, p-update — matching
the paper's region abstraction.  Acceptance verification: true relative
residual ||b - A x|| / ||b|| below tolerance (a math-invariant check, §2.2).

CG is the paper's interesting case: its short-term recurrence is *fragile*
(stale p/r break conjugacy), so recomputation often needs extra iterations
(S2) — the paper reports 9.1 extra iterations on average and a 49 % gap to
best-achievable recomputability.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .common import as_numpy, as_tensor, laplacian_apply, rel_residual, tree_sum


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis in float32, in the fixed tree order."""
    return tree_sum(a * b)


def _f32(x) -> np.ndarray:
    return np.array([x], np.float32)


def _f32_scalar(x: float) -> float:
    """``x`` rounded to float32, as a Python float (which a float32 tensor
    op then takes exactly)."""
    return float(np.float32(x))


class CGApp(IterativeApp):
    """CG with periodic residual replacement (van der Vorst/Ye), the standard
    HPC guard against recurrence drift — and the mechanism that lets CG
    absorb block-stale state after an EasyCrash restart."""

    name = "cg"
    candidates = ("x", "r", "p", "q", "rho", "rho_prev", "alpha", "k")

    def __init__(
        self,
        grid: int = 48,
        tol: float = 1e-4,
        n_iters: int = 600,
        seed: int = 0,
        residual_replace_every: int = 20,
        device: str = "cuda",
    ):
        self.grid = grid
        self.tol = tol
        self.n_iters = n_iters
        self._seed = seed
        self.rr_every = residual_replace_every
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ state
    def init(self, seed: int = 0) -> State:
        g = self.grid
        rng = np.random.default_rng(self._seed)
        x_true = rng.standard_normal(g * g).astype(np.float32)
        b = as_numpy(laplacian_apply(as_tensor(x_true, self.device), g))
        x = np.zeros(g * g, np.float32)
        r = b.copy()
        p = r.copy()
        rho = np.array([float(r @ r)], np.float32)
        return {
            "x": x, "r": r, "p": p, "q": np.zeros_like(x),
            "rho": rho, "rho_prev": rho.copy(), "alpha": np.zeros(1, np.float32),
            "k": np.zeros(1, np.int64),
            "b": b,  # read-only
        }

    def _t(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _rr(self, k: int) -> bool:
        """Whether iteration ``k`` replaces the residual."""
        return bool(self.rr_every) and (k + 1) % self.rr_every == 0

    # ---------------------------------------------------------------- regions
    def _matvec(self, s: State) -> State:
        s = dict(s)
        s["q"] = self._like(laplacian_apply(self._t(s["p"]), self.grid), s["p"])
        return s

    def _x_update(self, s: State) -> State:
        s = dict(s)
        pq = float(_dot(self._t(s["p"]), self._t(s["q"])))
        alpha = float(s["rho"][0]) / pq if pq != 0.0 else 0.0
        s["alpha"] = self._like(self._t(_f32(alpha)), s["alpha"])
        s["x"] = self._like(self._t(s["x"]) + _f32_scalar(alpha) * self._t(s["p"]), s["x"])
        return s

    def _r_update(self, s: State) -> State:
        s = dict(s)
        if self._rr(int(s["k"][0])):
            # residual replacement: recompute the *true* residual
            r = self._t(s["b"]) - laplacian_apply(self._t(s["x"]), self.grid)
        else:
            r = self._t(s["r"]) - float(s["alpha"][0]) * self._t(s["q"])
        rho = float(_dot(r, r))
        s["r"] = self._like(r, s["r"])
        s["rho_prev"] = self._like(self._t(s["rho"]).clone(), s["rho"])
        s["rho"] = self._like(self._t(_f32(rho)), s["rho"])
        return s

    def _p_update(self, s: State) -> State:
        s = dict(s)
        if self._rr(int(s["k"][0])):
            # restart direction after residual replacement
            p = self._t(s["r"]).clone()
        else:
            denom = float(s["rho_prev"][0])
            beta = float(s["rho"][0]) / denom if denom != 0.0 else 0.0
            p = self._t(s["r"]) + _f32_scalar(beta) * self._t(s["p"])
        s["p"] = self._like(p, s["p"])
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("matvec", self._matvec, writes=("q",), reads=("p",), cost=2.0),
            Region("x_update", self._x_update, writes=("alpha", "x"), reads=("p", "q", "rho", "x")),
            Region("r_update", self._r_update, writes=("r", "rho_prev", "rho"), reads=("alpha", "q", "r", "x", "b")),
            Region("p_update", self._p_update, writes=("p", "k"), reads=("r", "rho", "rho_prev", "p")),
        )

    # ----------------------------------------------------------- verification
    def verify(self, state: State) -> VerifyResult:
        res = rel_residual(state["x"], state["b"], self.grid, self.device)
        return VerifyResult(bool(np.isfinite(res) and res < self.tol), res)

    def progress(self, state: State) -> float:
        return rel_residual(state["x"], state["b"], self.grid, self.device)

    def _converged_rho(self, rho: float, nb: float) -> bool:
        # cheap recurrence-residual check every iteration; the *true*
        # residual is only asserted by verify()
        return bool(np.sqrt(max(rho, 0.0)) / max(nb, 1e-30) < self.tol * 0.5)

    def converged(self, state: State, it: int) -> bool:
        if it >= self.n_iters:
            return True
        rho = float(state["rho"][0])
        if not np.isfinite(rho):
            raise FloatingPointError("CG blow-up")
        return self._converged_rho(rho, float(np.linalg.norm(as_numpy(state["b"]))))

    # ------------------------------------------------------- batched recompute
    # ``b`` is read-only, so the hooks stack only the per-lane vectors and
    # take lane 0's right-hand side.  Vector ops are elementwise or stencils
    # on the stack, the dots tree_sum's fixed order per row, and the scalar
    # math the serial float64 host code per lane: each lane is bitwise the
    # serial one.
    supports_batched_step = True

    def _stack(self, states, name: str) -> torch.Tensor:
        return self._t(np.stack([as_numpy(s[name]) for s in states]))

    def _col(self, values) -> torch.Tensor:
        """Per-lane float32 scalars as an (L, 1) column."""
        return self._t(np.asarray(values, np.float32).reshape(-1, 1))

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        p3 = self._t(np.stack([s["p"]] * 3))
        g = self.grid
        return (
            BatchedKernel("lap_batch", lambda ub: laplacian_apply(ub, g), (p3,), {0: 0}),
            BatchedKernel("dot_batch", _dot, (p3, p3), {0: 0, 1: 0}),
        )

    def run_iteration_batch(self, states):
        g = self.grid
        b = self._t(as_numpy(states[0]["b"]))
        x, r, p = (self._stack(states, f) for f in ("x", "r", "p"))
        q = laplacian_apply(p, g)
        pq = as_numpy(_dot(p, q))
        alphas = []
        for i, s in enumerate(states):
            pqi = float(pq[i])
            alphas.append(float(s["rho"][0]) / pqi if pqi != 0.0 else 0.0)
        alpha = self._col(alphas)
        x = x + alpha * p
        # both branches computed, selected per lane (an exact select)
        use_rr = self._t(np.array([self._rr(int(s["k"][0])) for s in states]).reshape(-1, 1))
        r = torch.where(use_rr, b - laplacian_apply(x, g), r - alpha * q)
        rho = as_numpy(_dot(r, r))
        betas = []
        for i, s in enumerate(states):
            denom = float(s["rho"][0])  # the new rho_prev
            betas.append(float(rho[i]) / denom if denom != 0.0 else 0.0)
        p = torch.where(use_rr, r, r + self._col(betas) * p)
        x, r, p, q = (as_numpy(v) for v in (x, r, p, q))
        out = []
        for i, s in enumerate(states):
            s = dict(s)
            s["x"], s["r"], s["p"], s["q"] = x[i], r[i], p[i], q[i]
            s["alpha"] = _f32(alphas[i])
            s["rho_prev"] = np.array(s["rho"], copy=True)
            s["rho"] = _f32(float(rho[i]))
            s["k"] = s["k"] + 1
            out.append(s)
        return out

    def converged_batch(self, states, its):
        # pure host scalar math on the carried rho — exactly the serial hook,
        # with the lane-constant ||b|| computed once
        out: list = []
        nb = float(np.linalg.norm(as_numpy(states[0]["b"])))
        for s, it in zip(states, its):
            if it >= self.n_iters:
                out.append(True)
                continue
            rho = float(s["rho"][0])
            if not np.isfinite(rho):
                out.append(FloatingPointError("CG blow-up"))
            else:
                out.append(self._converged_rho(rho, nb))
        return out

    def verify_batch(self, states):
        # one batched Laplacian; the norms run in numpy per contiguous row,
        # exactly like the serial rel_residual
        b_rows = np.stack([as_numpy(s["b"]) for s in states])
        lap = as_numpy(laplacian_apply(self._stack(states, "x"), self.grid))
        out = []
        for i in range(len(states)):
            r = b_rows[i] - lap[i]
            nb = float(np.linalg.norm(b_rows[i]))
            res = float(np.linalg.norm(r)) / max(nb, 1e-30)
            out.append(VerifyResult(bool(np.isfinite(res) and res < self.tol), res))
        return out
