"""Plain PyTorch version of the RG-LRU scan (the kernel's oracle): a
sequential scan in f32.

The JAX oracle (``repro/kernels/rglru_scan/ref.py``) is an
``associative_scan``, which multiplies and adds in another order than any
sequential scan; the two agree to 1e-5 (abs and rel) at the test sizes,
not bit for bit.  This version rounds the product and the add one at a
time, as the TPU kernel's body (and the CUDA kernel) does.
"""
from __future__ import annotations

import torch


def rglru_reference(a, b):
    """a, b: (B, T, D) -> h (B, T, D) f32; h_t = a_t h_{t-1} + b_t, h_{-1} = 0."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
