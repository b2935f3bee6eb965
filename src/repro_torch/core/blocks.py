# Port copy of repro/core/blocks.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Block-granularity utilities.

EasyCrash reasons about persistence at *cache-block* granularity (64 B on
x86).  On TPU the analogous unit is the flush block used by the
``delta_snapshot`` kernel.  Everything in :mod:`repro.core` that mixes old and
new values, computes inconsistency rates or counts NVM writes does so in
units of blocks via these helpers.

Arrays are treated as flat byte streams; the final (possibly partial) block
is a real block (the paper's objects are not block-aligned either).
"""
from __future__ import annotations

import numpy as np

DEFAULT_BLOCK_BYTES = 64


def num_blocks(nbytes: int, block_bytes: int = DEFAULT_BLOCK_BYTES) -> int:
    """Number of cache blocks spanned by an object of ``nbytes`` bytes."""
    if nbytes <= 0:
        return 0
    return -(-nbytes // block_bytes)


def obj_nbytes(arr: np.ndarray) -> int:
    return int(np.asarray(arr).nbytes)


def obj_num_blocks(arr: np.ndarray, block_bytes: int = DEFAULT_BLOCK_BYTES) -> int:
    return num_blocks(obj_nbytes(arr), block_bytes)


def _as_byte_view(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of an array (no copy)."""
    a = np.ascontiguousarray(arr)
    return a.view(np.uint8).reshape(-1)


def mix_blocks(
    old: np.ndarray,
    new: np.ndarray,
    new_block_mask: np.ndarray,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
) -> np.ndarray:
    """Blockwise select: where ``new_block_mask[b]`` take ``new``, else ``old``.

    This is the post-crash NVM image constructor: persisted blocks carry the
    new value, lost (dirty-in-cache) blocks retain the stale one.
    """
    old = np.asarray(old)
    new = np.asarray(new)
    if old.shape != new.shape or old.dtype != new.dtype:
        raise ValueError(f"mix_blocks shape/dtype mismatch: {old.shape}/{old.dtype} vs {new.shape}/{new.dtype}")
    nb = obj_num_blocks(old, block_bytes)
    mask = np.asarray(new_block_mask, dtype=bool)
    if mask.shape != (nb,):
        raise ValueError(f"mask must have {nb} blocks, got {mask.shape}")
    if nb == 0:
        return old.copy()
    ob = _as_byte_view(old).copy()
    nbv = _as_byte_view(new)
    byte_mask = np.repeat(mask, block_bytes)[: ob.size]
    ob[byte_mask] = nbv[byte_mask]
    return ob.view(old.dtype).reshape(old.shape)


def inconsistent_rate(
    image: np.ndarray,
    truth: np.ndarray,
) -> float:
    """Fraction of *bytes* in ``image`` that differ from ``truth``.

    Matches NVCT's "data inconsistent rate": dirty (lost) bytes divided by
    the object size.
    """
    a = _as_byte_view(np.asarray(image))
    b = _as_byte_view(np.asarray(truth))
    if a.size != b.size:
        raise ValueError("size mismatch")
    if a.size == 0:
        return 0.0
    return float(np.count_nonzero(a != b)) / a.size


def block_diff_mask(
    a: np.ndarray,
    b: np.ndarray,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
) -> np.ndarray:
    """Per-block "changed" mask between two same-shaped arrays.

    CPU reference for the ``delta_snapshot`` Pallas kernel: a block is dirty
    iff any byte within it differs.
    """
    av = _as_byte_view(np.asarray(a))
    bv = _as_byte_view(np.asarray(b))
    if av.size != bv.size:
        raise ValueError("size mismatch")
    nb = num_blocks(av.size, block_bytes)
    if nb == 0:
        return np.zeros((0,), dtype=bool)
    diff = av != bv
    pad = nb * block_bytes - av.size
    if pad:
        diff = np.concatenate([diff, np.zeros(pad, dtype=bool)])
    return diff.reshape(nb, block_bytes).any(axis=1)
