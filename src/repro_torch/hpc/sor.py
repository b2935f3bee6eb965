"""SOR: red-black successive over-relaxation on the 2-D Poisson problem.

Torch port of ``repro/hpc/sor.py``; see that module for the app's role in the
suite.  The app computes on ``self.device`` (CUDA unless ``device="cpu"`` is
passed).  Region functions keep the JAX app's contract for numpy state
(numpy in, numpy out, so the copied crash tester drives them unchanged) and
keep a tensor state on its device (the deployment loop's state stays on the
card).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .common import as_numpy, as_tensor, laplacian_apply, rel_residual


def _rb_sor(u_flat: torch.Tensor, b_flat: torch.Tensor, g: int, omega: float,
            pairs: int) -> torch.Tensor:
    """``pairs`` red/black half-sweep pairs; leading dimensions are lanes."""
    u = u_flat.reshape(*u_flat.shape[:-1], g, g)
    b = b_flat.reshape(*b_flat.shape[:-1], g, g)
    idx = torch.arange(g, device=u.device)
    red = ((idx[:, None] + idx[None, :]) % 2 == 0).to(u.dtype)
    # omega as float32, as jit passes the Python float to the JAX kernel
    om = torch.tensor(np.float32(omega), dtype=u.dtype, device=u.device)
    w_red, w_black = om * red, om * (1.0 - red)

    def half_sweep(u, w):
        nb = (
            F.pad(u[..., 1:, :], (0, 0, 0, 1))
            + F.pad(u[..., :-1, :], (0, 0, 1, 0))
            + F.pad(u[..., :, 1:], (0, 1))
            + F.pad(u[..., :, :-1], (1, 0))
        )
        gs = (b + nb) / 4.0
        # XLA contracts u + (omega*mask)*(gs-u) into one fused multiply-add;
        # addcmul rounds once the same way, so the sweep is bitwise JAX's.
        # Separate mul and add ops drift by up to 1.7e-5 after 50 pairs.
        return torch.addcmul(u, w, gs - u)

    for _ in range(pairs):
        u = half_sweep(u, w_red)
        u = half_sweep(u, w_black)
    return u.reshape(u_flat.shape)


class SORApp(IterativeApp):
    name = "sor"
    candidates = ("u", "res", "k")
    fault_defaults = {
        "correlated-region": {"shape": 4.0},
        "torn-write": {"p_torn": 0.7, "depth": 16},
    }

    def __init__(self, grid: int = 32, tol: float = 1e-4, n_iters: int = 200,
                 seed: int = 0, omega: float | None = None, pairs_per_iter: int = 2,
                 device: str = "cuda"):
        self.grid = grid
        self.tol = tol
        self.n_iters = n_iters
        self._seed = seed
        self.omega = float(omega) if omega is not None else 2.0 / (1.0 + np.sin(np.pi / grid))
        self.pairs_per_iter = pairs_per_iter
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> State:
        g = self.grid
        rng = np.random.default_rng(self._seed)
        ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        b = np.zeros((g, g), np.float32)
        for _ in range(3):
            ci, cj = rng.uniform(g * 0.2, g * 0.8, size=2)
            s = rng.uniform(g / 8, g / 4)
            b += rng.uniform(0.5, 1.5) * np.exp(-((ii - ci) ** 2 + (jj - cj) ** 2) / (2 * s * s))
        return {
            "u": np.zeros(g * g, np.float32),
            "res": np.zeros(g * g, np.float32),  # temporal diagnostic
            "k": np.zeros(1, np.int64),
            "b": b.reshape(-1).astype(np.float32),  # read-only
        }

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _region_residual(self, s: State) -> State:
        s = dict(s)
        lap = laplacian_apply(as_tensor(s["u"], self.device), self.grid)
        s["res"] = s["b"] - self._like(lap, s["b"])
        return s

    def _region_sweep(self, s: State) -> State:
        s = dict(s)
        u = _rb_sor(as_tensor(s["u"], self.device), as_tensor(s["b"], self.device),
                    self.grid, self.omega, self.pairs_per_iter)
        s["u"] = self._like(u, s["u"])
        return s

    def _region_book(self, s: State) -> State:
        s = dict(s)
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("residual", self._region_residual, writes=("res",), reads=("u", "b"), cost=1.0),
            Region("sweep", self._region_sweep, writes=("u",), reads=("u", "b"), cost=2.0),
            Region("book", self._region_book, writes=("k",), cost=0.1),
        )

    def _residual(self, state: State) -> float:
        return rel_residual(state["u"], state["b"], self.grid, self.device)

    def verify(self, state: State) -> VerifyResult:
        r = self._residual(state)
        return VerifyResult(bool(np.isfinite(r) and r < self.tol), r)

    def progress(self, state: State) -> float:
        return self._residual(state)

    def converged(self, state: State, it: int) -> bool:
        if it >= self.n_iters:
            return True
        r = self._residual(state)
        if not np.isfinite(r):
            raise FloatingPointError("SOR blow-up")
        return r < self.tol * 0.95

    # ------------------------------------------------------- batched recompute
    # The lanes are an explicit leading dimension of one stacked tensor; the
    # sweep and the Laplacian are elementwise and stencil ops only, so each
    # lane's result is bitwise the serial one.
    supports_batched_step = True

    def _stack(self, states, name: str) -> torch.Tensor:
        return as_tensor(np.stack([as_numpy(s[name]) for s in states]), self.device)

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        u3 = as_tensor(np.stack([s["u"]] * 3), self.device)
        b3 = as_tensor(np.stack([s["b"]] * 3), self.device)
        g, om, pairs = self.grid, self.omega, self.pairs_per_iter
        return (
            BatchedKernel("lap_batch", lambda ub: laplacian_apply(ub, g), (u3,), {0: 0}),
            BatchedKernel("rb_sor_batch", lambda ub, bb: _rb_sor(ub, bb, g, om, pairs),
                          (u3, b3), {0: 0, 1: 0}),
        )

    def _residuals_batch(self, states) -> list:
        """rel_residual per lane with one batched Laplacian; the norms run in
        numpy per contiguous row, exactly like the serial path."""
        b_rows = np.stack([as_numpy(s["b"]) for s in states])
        lap = as_numpy(laplacian_apply(self._stack(states, "u"), self.grid))
        out = []
        for i in range(len(states)):
            r = b_rows[i] - lap[i]
            nb = float(np.linalg.norm(b_rows[i]))
            out.append(float(np.linalg.norm(r)) / max(nb, 1e-30))
        return out

    def run_iteration_batch(self, states):
        b_rows = np.stack([as_numpy(s["b"]) for s in states])
        u_dev = self._stack(states, "u")
        # region order preserved: the residual diagnostic reads the pre-sweep u
        lap = as_numpy(laplacian_apply(u_dev, self.grid))
        u_new = as_numpy(_rb_sor(u_dev, as_tensor(b_rows, self.device), self.grid,
                                 self.omega, self.pairs_per_iter))
        out = []
        for i, s in enumerate(states):
            s = dict(s)
            s["res"] = b_rows[i] - lap[i]
            s["u"] = u_new[i]
            s["k"] = s["k"] + 1
            out.append(s)
        return out

    def converged_batch(self, states, its):
        out: list = [None] * len(states)
        need = []
        for i, it in enumerate(its):
            if it >= self.n_iters:
                out[i] = True  # serial converged() returns before the residual
            else:
                need.append(i)
        if need:
            rs = self._residuals_batch([states[i] for i in need])
            for i, r in zip(need, rs):
                if not np.isfinite(r):
                    out[i] = FloatingPointError("SOR blow-up")
                else:
                    out[i] = bool(r < self.tol * 0.95)
        return out

    def verify_batch(self, states):
        return [
            VerifyResult(bool(np.isfinite(r) and r < self.tol), r)
            for r in self._residuals_batch(states)
        ]
