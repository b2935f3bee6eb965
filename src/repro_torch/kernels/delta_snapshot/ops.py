"""Public dirty-block op: flat tensors in, per-block int32 mask out.

A CUDA tensor goes to the hand-written kernel in
``kernels/csrc/delta_snapshot.cu`` (uint8 or float32, contiguous) or the
call raises; a CPU tensor goes to the plain version in :mod:`.ref`.
``dirty_block_mask.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import dirty_block_mask_reference

DEFAULT_BLOCK_ELEMS = 256
_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1}


def dirty_block_mask(x: torch.Tensor, prev: torch.Tensor, *,
                     block_elems: int = DEFAULT_BLOCK_ELEMS) -> torch.Tensor:
    """x, prev: same-shape, same-dtype tensors -> int32 (n_blocks,) mask;
    block ``b`` is 1 iff an element of ``x`` in it differs from ``prev``."""
    if not isinstance(x, torch.Tensor) or not isinstance(prev, torch.Tensor):
        raise TypeError("dirty_block_mask takes torch tensors")
    if x.shape != prev.shape or x.dtype != prev.dtype or x.device != prev.device:
        raise ValueError(
            f"x and prev differ: {x.shape}/{x.dtype}/{x.device} vs "
            f"{prev.shape}/{prev.dtype}/{prev.device}"
        )
    block_elems = int(block_elems)
    if block_elems < 1:
        raise ValueError(f"block_elems must be >= 1, got {block_elems}")
    if x.device.type == "cpu":
        return dirty_block_mask_reference(x, prev, block_elems)
    if x.device.type != "cuda":
        raise ValueError(f"dirty_block_mask runs on cuda or cpu tensors, not {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"the CUDA dirty_block_mask takes uint8 or float32, not {x.dtype}")
    if not (x.is_contiguous() and prev.is_contiguous()):
        raise ValueError("the CUDA dirty_block_mask takes contiguous tensors")
    n = x.numel()
    nb = -(-n // block_elems)
    out = torch.empty(nb, dtype=torch.int32, device=x.device)
    if nb == 0:
        return out
    fn = _build.load("delta_snapshot").delta_snapshot_mask
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), prev.data_ptr(), n, block_elems, code, out.data_ptr(), nb, stream)
    if err != 0:
        raise RuntimeError(f"delta_snapshot kernel launch failed: CUDA error {err}")
    dirty_block_mask.launches += 1
    return out


dirty_block_mask.launches = 0
