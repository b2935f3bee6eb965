"""Public flash-attention op in the model's (B, S, H, D) layout.

A CUDA tensor goes to the hand-written kernel in
``kernels/csrc/flash_attention.cu`` (float32 or bfloat16, D 64, 128 or
256) or the call raises; a CPU tensor goes to the plain version in
:mod:`.ref`.  ``flash_attention.launches`` counts kernel launches.

``block_q`` and ``block_k`` keep the JAX op's contract: the sequence must be
a multiple of ``min(block, S)``.  The kernel's q tile is 64 rows; its kv
tile is ``block_k`` where that is 32 or 64, and 64 for anything larger (a
128-row f32 k and v tile at D 256 is 256 KiB, more than a CTA's shared
memory).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _build
from .ref import attention_reference

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: Optional[int] = None,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """q, k, v: (B, S, H, D) (same head counts: repeat GQA upstream)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must share one dtype and device")
    b, s, h, d = q.shape
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"sequence {s} is not a multiple of the blocks ({bq}, {bk})")
    if q.device.type == "cpu":
        out = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"the CUDA flash_attention takes float32 or bfloat16, not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash_attention takes head dims {_HEAD_DIMS}, not {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kv_tile = 32 if bk <= 32 else 64
    scale = float(np.float32(d ** -0.5))
    fn = _build.load("flash_attention").flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
                 int(causal), int(window or 0), kv_tile, scale, code, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
