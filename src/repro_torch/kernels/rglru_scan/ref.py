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


def rglru_reference_backward(a, b, dh):
    """The gradient of :func:`rglru_reference`: a, b, dh (B, T, D) ->
    (da, db) (B, T, D) f32.  Backward through the chain with the carried
    gradient g_t = dh_t + a_{t+1} g_{t+1}: db_t = g_t, da_t = g_t h_{t-1}."""
    a, dh = a.float(), dh.float()
    h = rglru_reference(a, b)
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + carry
        db[:, t] = g
        da[:, t] = g * h[:, t - 1] if t else torch.zeros_like(g)
        carry = a[:, t] * g
    return da, db
