"""Frozen operation and byte counts, and the H100's published peaks.

This module holds the peaks and the kernels' bounds; ``<counts>.py``
beside it, named by a configuration's ``counts`` key, holds the counts of
one kind of deployment (``heat``: bytes an iteration needs).

Every bound here is the least the work needs, counted from shapes: each
input byte read once, each output byte written once, whatever a kernel
reads again.  A share of a bound is ``bound time / measured time`` and
cannot pass 100 % unless the count is wrong.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12


def num_blocks(nbytes: int, block_bytes: int) -> int:
    return -(-int(nbytes) // int(block_bytes))


def delta_bound_s(nbytes: int, block_bytes: int) -> float:
    """Least time of one ``delta_snapshot`` mask over a leaf of ``nbytes``:
    the live bytes and the shadow read once, one int32 per block written
    once, at the HBM rate: ``(2 * nbytes + 4 * ceil(nbytes / block)) / BW``."""
    return (2 * int(nbytes) + 4 * num_blocks(nbytes, block_bytes)) / HBM_BYTES_PER_S

