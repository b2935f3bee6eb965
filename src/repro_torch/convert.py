"""State carried between numpy (the JAX package's and the arena's currency)
and torch tensors, byte for byte in both directions."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def state_to_torch(state: Mapping[str, np.ndarray], device: str) -> Dict[str, torch.Tensor]:
    """Each leaf as a tensor on ``device`` with the same dtype, shape and bytes."""
    return {
        k: torch.from_numpy(np.array(v, copy=True)).to(device)
        for k, v in state.items()
    }


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Each leaf as a host numpy array with the same dtype, shape and bytes."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in state.items()}
