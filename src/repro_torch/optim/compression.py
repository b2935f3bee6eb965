# Port of repro/optim/compression.py.  What differs: torch ops; ``dtype``
# arguments are torch dtypes; the top-k indices are int32 as jax.lax.top_k
# gives them.  torch.topk, like jax.lax.top_k, returns the values in
# descending order; how it orders equal magnitudes is its own.
"""Gradient compression for the DP all-reduce: top-k + error feedback, int8.

Distributed-optimization trick for bandwidth-bound data parallelism: the
all-reduce moves top-k values+indices (or int8-quantized tensors) instead of
full bf16 gradients.  Error feedback accumulates the dropped residual so the
compression is unbiased over time (Stich et al., 2018).

The launcher enables them with ``--grad-compression topk:0.01`` / ``int8``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def compress_topk(g: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the largest-|g| fraction.  Returns (values, indices, residual)."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(flat.abs(), k)
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx.to(torch.int32), residual.reshape(g.shape).to(g.dtype)


def decompress_topk(vals: torch.Tensor, idx: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = torch.zeros((math.prod(shape),), dtype=torch.float32, device=vals.device)
    flat[idx.long()] = vals
    return flat.reshape(shape).to(dtype)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    a = g.float().abs().max()
    scale = torch.clamp(a / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
