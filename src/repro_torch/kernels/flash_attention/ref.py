"""Plain PyTorch version of flash attention (the kernel's oracle): the
materialized-scores transcription of ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D); the scores scaled by ``scale``
    (default ``D ** -0.5``); f32 inside, rounded once to q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (d ** -0.5 if scale is None else scale)
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
