# Port of repro/hpc/heat.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * The explicit step rounds once: XLA contracts ``u + dt * lap`` into one
#   fused multiply-add, and torch.addcmul(u, lap, dt) rounds the same way
#   (bitwise JAX's on the CPU; separate mul and add ops differ from it after
#   one step).  Inside the Laplacian, XLA may contract ``sum - 4.0 * u``
#   too, but 4.0 * u is exact, so the plain ops give its bits either way.
# * fori_loop is a Python loop of ``steps_per_iter`` steps; the pin scatter
#   is ``where(pin_mask, 1.0, u)`` in both the serial and the batched step
#   (the same values as the scatter: exactly 1.0 at the pins).
# * advance_lanes runs core/lane_driver.py's device loop over _step_core,
#   the tensor core of run_iteration_batch (a CUDA graph on the card).
"""HEAT: explicit 2-D heat diffusion to steady state (LULESH/SP stand-in:
structured-grid time stepping with strong smoothing dynamics).

A plate with implicit zero boundary and a few *pinned* (fixed-temperature)
source cells; explicit diffusion relaxes to the discrete harmonic solution.
Three regions: flux/diagnostic, explicit update (pins re-imposed inside the
step so equilibrium is exact), pin/bookkeeping.  The parabolic smoother damps
block-local perturbations exponentially, so this is the strongly-recomputable
end of the spectrum (the paper's SP at 88 %).

Acceptance verification: steady-state residual max|lap(u)| over non-source
cells below tolerance (physical-law check: harmonic balance).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .common import as_numpy, as_tensor


def _laplace(u_flat: torch.Tensor, g: int) -> torch.Tensor:
    """The 5-point Laplacian with zero boundary; leading dimensions are lanes."""
    u = u_flat.reshape(*u_flat.shape[:-1], g, g)
    lap = (
        F.pad(u[..., 1:, :], (0, 0, 0, 1))
        + F.pad(u[..., :-1, :], (0, 0, 1, 0))
        + F.pad(u[..., :, 1:], (0, 1))
        + F.pad(u[..., :, :-1], (1, 0))
        - 4.0 * u
    )
    return lap.reshape(u_flat.shape)


def _diffuse(u_flat: torch.Tensor, pin_mask: torch.Tensor, g: int, steps: int,
             dt: float) -> torch.Tensor:
    """``steps`` explicit steps, the pins set to 1.0 after each; leading
    dimensions of ``u_flat`` are lanes, ``pin_mask`` is one lane's."""
    # dt as float32, as jit folds the static Python float into the program
    # (fills, not host copies: the lane driver's CUDA graph captures them)
    dt_t = torch.full((), float(np.float32(dt)), dtype=u_flat.dtype, device=u_flat.device)
    one = torch.ones((), dtype=u_flat.dtype, device=u_flat.device)
    u = u_flat
    for _ in range(steps):
        u = torch.where(pin_mask, one, torch.addcmul(u, _laplace(u, g), dt_t))
    return u


def _step_core(u_b: torch.Tensor, pin_mask: torch.Tensor, g: int, steps: int,
               dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration on stacked lanes: (flux, u) of the flux, update and pin
    regions (the pin region re-imposes the sources after the update)."""
    flux = _laplace(u_b, g)
    return flux, torch.where(pin_mask, 1.0, _diffuse(u_b, pin_mask, g, steps, dt))


class HeatApp(IterativeApp):
    name = "heat"
    candidates = ("u", "k")

    def __init__(self, grid: int = 48, tol: float = 1e-4, n_iters: int = 600,
                 seed: int = 0, dt: float = 0.2, steps_per_iter: int = 8,
                 device: str = "cuda"):
        self.grid = grid
        self.tol = tol
        self.n_iters = n_iters
        self._seed = seed
        self.dt = dt
        self.steps_per_iter = steps_per_iter
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> State:
        g = self.grid
        rng = np.random.default_rng(self._seed)
        idx = rng.choice(np.arange(g * g).reshape(g, g)[g // 4 : 3 * g // 4,
                                                        g // 4 : 3 * g // 4].reshape(-1),
                         size=4, replace=False).astype(np.int32)
        u = np.zeros(g * g, np.float32)
        u[idx] = 1.0
        return {
            "u": u,
            "flux": np.zeros(g * g, np.float32),  # temporal diagnostic
            "k": np.zeros(1, np.int64),
            "pins": idx,  # read-only
        }

    def _like(self, t: torch.Tensor, ref):
        """``t`` in the kind of ``ref``: numpy for numpy state, else a tensor."""
        return t if isinstance(ref, torch.Tensor) else as_numpy(t)

    def _pin_mask(self, pins) -> torch.Tensor:
        mask = torch.zeros(self.grid * self.grid, dtype=torch.bool, device=self.device)
        mask[as_tensor(pins, self.device).long()] = True
        return mask

    def _region_flux(self, s: State) -> State:
        s = dict(s)
        s["flux"] = self._like(_laplace(as_tensor(s["u"], self.device), self.grid), s["u"])
        return s

    def _region_update(self, s: State) -> State:
        s = dict(s)
        u = _diffuse(as_tensor(s["u"], self.device), self._pin_mask(s["pins"]), self.grid,
                     self.steps_per_iter, self.dt)
        s["u"] = self._like(u, s["u"])
        return s

    def _region_pin(self, s: State) -> State:
        s = dict(s)
        if isinstance(s["u"], torch.Tensor):
            u = s["u"].clone()
            u[s["pins"].long()] = 1.0
        else:
            u = s["u"].copy()
            u[s["pins"]] = 1.0
        s["u"] = u
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("flux", self._region_flux, writes=("flux",), reads=("u",), cost=1.0),
            Region("update", self._region_update, writes=("u",), reads=("u",), cost=2.0),
            Region("pin", self._region_pin, writes=("u", "k"), reads=("u",), cost=0.5),
        )

    def _residual(self, state: State) -> float:
        lap = _laplace(as_tensor(state["u"], self.device), self.grid)
        res = lap.abs().masked_fill(self._pin_mask(state["pins"]), 0.0)
        return float(res.max())

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
            raise FloatingPointError("heat blow-up")
        return r < self.tol * 0.5

    # ------------------------------------------------------- batched recompute
    # ``pins`` is read-only (rebuilt identically by every restart), so the
    # hooks stack only the temperature fields and take lane 0's pin mask.
    # The step and the Laplacian are elementwise and stencil ops only, and
    # abs/max are exact, so each lane is bitwise the serial one.
    supports_batched_step = True
    supports_lane_driver = True

    def _stack(self, states, name: str) -> torch.Tensor:
        return as_tensor(np.stack([as_numpy(s[name]) for s in states]), self.device)

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        u3 = as_tensor(np.stack([s["u"]] * 3), self.device)
        mask = self._pin_mask(s["pins"])
        g, steps, dt = self.grid, self.steps_per_iter, self.dt
        return (
            BatchedKernel("heat_step_batch", lambda ub: _diffuse(ub, mask, g, steps, dt),
                          (u3,), {0: 0}),
            BatchedKernel("lap_batch", lambda ub: _laplace(ub, g), (u3,), {0: 0}),
        )

    def run_iteration_batch(self, states):
        flux_b, u_new = _step_core(self._stack(states, "u"), self._pin_mask(states[0]["pins"]),
                                   self.grid, self.steps_per_iter, self.dt)
        flux_b, u_new = as_numpy(flux_b), as_numpy(u_new)
        out = []
        for i, s in enumerate(states):
            s = dict(s)
            s["flux"] = flux_b[i]
            s["u"] = u_new[i]
            s["k"] = s["k"] + 1
            out.append(s)
        return out

    def _residuals_batch(self, states) -> list:
        """max|lap(u)| per lane (pins zeroed) with one batched Laplacian;
        abs and max are exact, so each value is bitwise the serial one."""
        lap = _laplace(self._stack(states, "u"), self.grid)
        res = lap.abs().masked_fill(self._pin_mask(states[0]["pins"]), 0.0)
        return [float(v) for v in res.amax(dim=1)]

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
                    out[i] = FloatingPointError("heat blow-up")
                else:
                    out[i] = bool(r < self.tol * 0.5)
        return out

    def verify_batch(self, states):
        return [
            VerifyResult(bool(np.isfinite(r) and r < self.tol), r)
            for r in self._residuals_batch(states)
        ]

    def advance_lanes(self, states, its, stop):
        from ..core.lane_driver import LaneSpec, cached_driver, f32_monotone_cutoff

        g, steps, dt, n_iters = self.grid, self.steps_per_iter, self.dt, self.n_iters
        cutoff = float(f32_monotone_cutoff(lambda v: v < self.tol * 0.5))

        def step(consts, a):
            flux, u = _step_core(a["u"], consts["pin_mask"], g, steps, dt)
            return {"u": u, "flux": flux, "k": a["k"] + 1}

        def check(consts, a, it):
            r = _laplace(a["u"], g).abs().masked_fill(consts["pin_mask"], 0.0).amax(dim=1)
            over = it >= n_iters
            fin = torch.isfinite(r)
            conv = over | (fin & (r <= cutoff))
            suspect = ~over & ~fin  # serial converged() would raise
            return conv, suspect

        key = ("heat", g, self.tol, n_iters, self._seed, dt, steps, self.device)
        drv = cached_driver(key, lambda: LaneSpec(
            carry=("u", "flux", "k"),
            consts=lambda s0: {"pin_mask": self._pin_mask(s0["pins"])},
            step=step, check=check, device=self.device,
        ))
        return drv.advance(states, its, stop)
