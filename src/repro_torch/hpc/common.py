"""Shared numerics for the HPC app suite, ported to torch.

Only what ``sor`` needs so far: the matrix-free Laplacian and the relative
residual.  ``jacobi_sweep``, ``restrict`` and ``prolong`` of
``repro/hpc/common.py`` come with heat and mg.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def laplacian_apply(x_flat: torch.Tensor, g: int) -> torch.Tensor:
    """y = A x for the 2-D 5-point Laplacian (Dirichlet) on a g x g grid.

    A is SPD with stencil [4, -1, -1, -1, -1]; matrix-free.  Leading
    dimensions of ``x_flat`` are batch dimensions; each lane's result is
    bitwise the serial one (elementwise ops only).
    """
    x = x_flat.reshape(*x_flat.shape[:-1], g, g)
    y = 4.0 * x
    y = y - F.pad(x[..., 1:, :], (0, 0, 0, 1))
    y = y - F.pad(x[..., :-1, :], (0, 0, 1, 0))
    y = y - F.pad(x[..., :, 1:], (0, 1))
    y = y - F.pad(x[..., :, :-1], (1, 0))
    return y.reshape(x_flat.shape)


def as_tensor(x, device: str) -> torch.Tensor:
    """``x`` as a tensor on ``device``; a tensor passes through as it is."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_residual(u, b, g: int, device: str) -> float:
    """||b - A u|| / ||b||: the Laplacian on ``device``, the norms in numpy on
    the host, as the JAX package splits it."""
    bn = as_numpy(b)
    r = bn - as_numpy(laplacian_apply(as_tensor(u, device), g))
    nb = float(np.linalg.norm(bn))
    return float(np.linalg.norm(r)) / max(nb, 1e-30)
