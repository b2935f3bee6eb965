"""Plain explicit 2-D heat diffusion: the reference of the heat cells.

The solver the ``deploy`` runner drives (a ``g x g`` plate, zero boundary,
the 5-point Laplacian, ``u <- u + dt * lap(u)`` then the pins set to 1.0,
``steps`` times per iteration; the flux diagnostic is ``lap(u)`` of the
iteration's input) written with slices, in place, with no kernel of the
port.  Its sums run in another order than the program's and its update
rounds twice where the program's fused multiply-add rounds once, so the
two differ by rounding only: float32 keeps the relative gap near 1e-6
after thousands of steps (the diffusion damps what each step adds), while
the same solver in bfloat16 (the control) loses every increment under
half an ulp of the field near a pin and ends far away.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _laplacian(u: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` = 5-point Laplacian of the 2-D field ``u``, zero outside."""
    torch.mul(u, -4.0, out=out)
    out[1:, :].add_(u[:-1, :])
    out[:-1, :].add_(u[1:, :])
    out[:, 1:].add_(u[:, :-1])
    out[:, :-1].add_(u[:, 1:])
    return out


def initial_field(grid: int, pins: torch.Tensor, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """The field before the first iteration: 0, and 1.0 at the pins."""
    u = torch.zeros(grid * grid, dtype=dtype, device=device)
    u[pins.long().to(device)] = 1.0
    return u


def heat_solve(grid: int, pins: torch.Tensor, dt: float, steps: int, iters: int,
               dtype=torch.float32, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, flux) after ``iters`` iterations from :func:`initial_field`,
    both flat ``(grid * grid,)`` in ``dtype``."""
    u = initial_field(grid, pins, dtype, device).reshape(grid, grid)
    lap = torch.empty_like(u)
    flux = torch.zeros_like(u)
    idx = pins.long().to(device)
    flat = u.view(-1)
    for it in range(iters):
        if it == iters - 1:
            _laplacian(u, flux)
        for _ in range(steps):
            _laplacian(u, lap)
            u.add_(lap, alpha=dt)
            flat[idx] = 1.0
    return u.reshape(-1), flux.reshape(-1)


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|`` in float64 (``inf`` if a value is
    not finite or the shapes differ)."""
    if got.shape != want.shape:
        return float("inf")
    g, w = got.double(), want.double().to(got.device)
    den = float(w.abs().max())
    gap = float((g - w).abs().max())
    if gap != gap:
        return float("inf")
    return gap / max(den, 1e-30)


def compare(config, inputs, iters: int, outputs, dtype=torch.float32,
            memo: Optional[dict] = None) -> dict:
    """The number the heat cells' check compares: ``state_gap``, the larger
    of the field's and the flux's :func:`relative_gap` against this
    reference after ``iters`` iterations.  With ``dtype`` below float32 the
    reference in that precision is put in the program's place (the
    control).  ``memo`` keeps the float32 solution for a second call."""
    a = config["app_args"]
    device = outputs["u"].device
    memo = {} if memo is None else memo

    def solve(dt):
        if dt not in memo:
            memo[dt] = heat_solve(int(a["grid"]), inputs["pins"], float(a["dt"]),
                                  int(a["steps_per_iter"]), iters, dt, device)
        return memo[dt]

    u, flux = solve(torch.float32)
    if dtype != torch.float32:
        outputs = dict(zip(("u", "flux"), solve(dtype)))
    return {"state_gap": max(relative_gap(outputs["u"], u), relative_gap(outputs["flux"], flux))}
