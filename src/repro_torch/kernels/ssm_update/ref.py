"""Plain PyTorch version of the Mamba-2 decode state update (the kernel's
oracle and the CPU path)."""
from __future__ import annotations

import torch


def ssm_update_reference(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """One token of the selective state-space recurrence, in float32.

    h: (Bt, H, P, N) state, updated in place; x: (Bt, H, P); dt: (Bt, H)
    (after softplus); A: (H,) (negative); B, C: (Bt, G, N), head ``i``
    reading group ``i // (H // G)``; D: (H,).  Returns y (Bt, H, P):

        h <- exp(dt * A) * h + (dt * x) outer B,    y = h @ C + D * x
    """
    n_heads, groups = h.shape[1], B.shape[1]
    Bh = B.repeat_interleave(n_heads // groups, dim=1)  # (Bt, H, N)
    Ch = C.repeat_interleave(n_heads // groups, dim=1)
    dA = torch.exp(dt * A)                               # (Bt, H)
    h.mul_(dA[:, :, None, None]).add_((dt[:, :, None] * x)[..., None] * Bh[:, :, None, :])
    return (h @ Ch[..., None])[..., 0] + D[:, None] * x
