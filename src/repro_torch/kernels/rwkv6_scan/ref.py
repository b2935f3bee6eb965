"""Plain PyTorch version of the RWKV-6 scan (the kernel's oracle): the
step-by-step transcription of ``repro/kernels/rwkv6_scan/ref.py``, with
``lax.scan`` written as a loop over the tokens.  With ``return_state`` it
also returns the loop's final state, as the CUDA kernel does."""
from __future__ import annotations

import torch


def rwkv6_reference(r, k, v, w, u, return_state: bool = False):
    """r, k, v, w: (B, H, T, D); u: (H, D) -> (B, H, T, D) f32, or with
    ``return_state`` (that, the final state S (B, H, D, D) f32)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    b, h, t, d = r.shape
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]  # (B, H, D)
        kv = kt[..., :, None] * vt[..., None, :]                          # (B, H, D, D)
        att = S + u[None, :, :, None] * kv
        ys[:, :, i] = torch.einsum("bhk,bhkv->bhv", rt, att)
        S = wt[..., :, None] * S + kv
    return (ys, S) if return_state else ys
