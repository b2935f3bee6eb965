# Port of repro/optim/schedule.py.  What differs: the step is a 0-d device
# tensor and the result a 0-d float32 tensor on its device; nothing reads
# either back to the host, so a train step that calls these does not sync.
"""Learning-rate schedules (no host sync)."""
from __future__ import annotations

import math

import torch


def _step_tensor(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step, dtype=torch.int32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    step = _step_tensor(step)
    return peak * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor_frac: float = 0.1) -> torch.Tensor:
    step = _step_tensor(step)
    warm = linear_warmup(step, warmup_steps, peak)
    prog = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
