"""Byte comparisons of flushed and restored images (exact: limit 0).

A delta flush must leave the arena image equal, byte for byte, to the live
leaf it flushed, and a restore must hand back exactly the last flushed
bytes.  Both are counted as differing bytes, so the limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch


#: bytes compared at a time: the images are gigabytes, and a compare of the
#: whole would hold a copy and a mask of that size on the device
CHUNK = 1 << 28


def _bytes(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def differing_bytes(got, want) -> int:
    """Bytes at which ``got`` and ``want`` (tensors or arrays) differ; a
    size mismatch counts every byte of the larger.  Compared on the device
    of the tensor among them, in chunks of ``CHUNK`` bytes."""
    device = next((x.device for x in (got, want) if isinstance(x, torch.Tensor)), "cpu")
    a, b = _bytes(got), _bytes(want)
    if a.numel() != b.numel():
        return max(a.numel(), b.numel(), 1)
    return sum(int(torch.count_nonzero(a[i:i + CHUNK].to(device) != b[i:i + CHUNK].to(device)))
               for i in range(0, a.numel(), CHUNK))
