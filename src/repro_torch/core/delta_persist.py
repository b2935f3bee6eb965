# Port of repro/core/delta_persist.py.  What differs: the mask comes from
# the port's delta_snapshot op (kernels/delta_snapshot), which takes numpy
# arrays or torch tensors; there is no silent fallback when the kernel is
# missing (a CUDA tensor reaches the kernel or the call raises), so
# kernel_available() and use_kernel are gone.
"""Incremental ("delta") persistence: dirty-block masks for the arena.

Bridges :mod:`repro_torch.kernels.delta_snapshot` to
:class:`repro_torch.core.arena.NVMArena`.  The arena reasons in *bytes*
(cache blocks of ``block_bytes``); the op compares element streams.  We
therefore run it over flat ``uint8`` views with ``block_elems = block_bytes``,
which makes the op's block boundary coincide exactly with the arena's — the
resulting mask is bit-for-bit the mask :func:`repro_torch.core.blocks.block_diff_mask`
computes, so a delta flush writes a byte-identical NVM image to a
whole-object flush.

Numpy inputs and CPU tensors take the op's plain version on the CPU; CUDA
tensors take the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.delta_snapshot import dirty_block_mask
from .blocks import DEFAULT_BLOCK_BYTES, _as_byte_view, obj_num_blocks


def _byte_tensor(a) -> torch.Tensor:
    """Flat uint8 view of a tensor or array (a copy only for a read-only array)."""
    if isinstance(a, torch.Tensor):
        if not a.is_contiguous():
            raise ValueError("delta_block_mask takes contiguous tensors")
        return a.reshape(-1).view(torch.uint8)
    v = _as_byte_view(np.asarray(a))
    return torch.from_numpy(v if v.flags.writeable else v.copy())


def delta_block_mask(cur, live, block_bytes: int = DEFAULT_BLOCK_BYTES):
    """Per-block "changed" mask between the NVM image and the live value.

    Same contract as :func:`repro_torch.core.blocks.block_diff_mask` (bool
    ``(n_blocks,)``, final partial block is a real block, padding never reads
    as dirty).  Numpy in, numpy out; tensors in (on one device), a bool
    tensor out on that device.
    """
    av = _byte_tensor(cur)
    bv = _byte_tensor(live)
    if av.numel() != bv.numel():
        raise ValueError("size mismatch")
    mask = dirty_block_mask(bv, av, block_elems=int(block_bytes)).to(torch.bool)
    if isinstance(cur, torch.Tensor) or isinstance(live, torch.Tensor):
        return mask
    return mask.numpy()


def persist_mask_for(
    mode: str,
    cur: Optional[np.ndarray],
    live: np.ndarray,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
) -> Optional[np.ndarray]:
    """Resolve a :class:`FlushPolicy.persist_mode` to an arena flush mask.

    ``None`` means "let the arena decide" (its own byte diff — the cache-model
    superset behaviour).  ``cur`` is the current NVM image (``arena.peek``),
    or ``None`` when the object has never been persisted / was reallocated,
    in which case the arena full-writes regardless of any mask.
    """
    if mode == "auto":
        return None
    live = np.asarray(live)
    if cur is None or cur.nbytes != live.nbytes:
        return None  # first flush / reallocation: arena full-writes
    if mode == "full":
        return np.ones(obj_num_blocks(live, block_bytes), dtype=bool)
    if mode == "delta":
        return delta_block_mask(cur, live, block_bytes)
    raise ValueError(f"unknown persist_mode {mode!r}; use 'auto', 'full' or 'delta'")
