"""Shared numerics for the HPC app suite, ported to torch.

The matrix-free Laplacian and the relative residual of
``repro/hpc/common.py``, and :func:`tree_sum`, the port's one reduction
order for the suite's float32 sums.  ``jacobi_sweep``, ``restrict`` and
``prolong`` come with mg.
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


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: zero-padded to a power of
    two, then halves added elementwise until one element is left.

    XLA's reduction order has no torch counterpart, and a torch sum's order
    may change with the shape, the alignment or the device.  Built from
    elementwise adds only, this sum is the same bits on the CPU and the
    card, and a lane of an (L, n) stack sums exactly as the same row alone,
    which is what the batched hooks need.  Leading dimensions are lanes;
    returns a tensor of the leading shape.
    """
    n = x.shape[-1]
    width = 1 << max(0, n - 1).bit_length()
    if width != n:
        x = F.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def as_tensor(x, device: str) -> torch.Tensor:
    """``x`` as a tensor on ``device``; a tensor passes through as it is.

    An array is copied into torch's own allocation (on the CPU aligned to
    64 bytes), so a BLAS call never sees an input at another alignment from
    one call to the next."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True)).to(device, copy=True)


def as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_residual(u, b, g: int, device: str) -> float:
    """||b - A u|| / ||b||: the Laplacian on ``device``, the norms in numpy on
    the host, as the JAX package splits it."""
    bn = as_numpy(b)
    r = bn - as_numpy(laplacian_apply(as_tensor(u, device), g))
    nb = float(np.linalg.norm(bn))
    return float(np.linalg.norm(r)) / max(nb, 1e-30)
