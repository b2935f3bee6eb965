"""Plain PyTorch version of the dirty-block mask (the kernel's oracle)."""
from __future__ import annotations

import torch


def dirty_block_mask_reference(x: torch.Tensor, prev: torch.Tensor, block_elems: int) -> torch.Tensor:
    """x, prev: same-shape tensors -> int32 (n_blocks,) changed mask.

    Both are flattened and zero-padded to a block multiple, as the JAX op
    does, so padding never reads as dirty.
    """
    xf, pf = x.reshape(-1), prev.reshape(-1)
    n = xf.numel()
    nb = -(-n // block_elems)
    pad = nb * block_elems - n
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
        pf = torch.cat([pf, pf.new_zeros(pad)])
    return (xf != pf).reshape(nb, block_elems).any(dim=1).to(torch.int32)
