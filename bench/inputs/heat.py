"""The heat plate's initial state from the seed: ``pins`` source cells
drawn without repeats in a ``pin_box`` square, itself placed in the
plate's middle half, all from the seed; the field 0 with 1.0 at the pins,
the flux diagnostic 0, the iteration counter 0.  The pins lie close enough
that their fronts meet early, so every seed solves a field of its own, and
every seed does the same work.  The layout is the state
``repro_torch.hpc.heat.HeatApp``'s regions take."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..harness import subseed
from ..reference.heat import initial_field


def make_inputs(config: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """The pin positions (int32, flat indices, ascending), the same for
    every call with this seed."""
    g, box = int(config["app_args"]["grid"]), int(config["pin_box"])
    rng = np.random.default_rng(subseed(seed, "heat-pins"))
    r0, c0 = rng.integers(g // 4, 3 * g // 4 - box, size=2)
    cells = rng.choice(box * box, size=int(config["pins"]), replace=False)
    idx = np.sort((r0 + cells // box) * g + (c0 + cells % box))
    return {"pins": torch.from_numpy(idx.astype(np.int32))}


def make_state(config: Dict, inputs: Dict[str, torch.Tensor], device: str) -> Dict:
    g = int(config["app_args"]["grid"])
    pins = inputs["pins"].to(device)
    return {
        "u": initial_field(g, pins, torch.float32, device),
        "flux": torch.zeros(g * g, dtype=torch.float32, device=device),
        "k": torch.zeros(1, dtype=torch.int64, device=device),
        "pins": pins,
    }
