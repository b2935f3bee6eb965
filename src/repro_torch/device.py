"""Device resolution for the port's entry points.

Every entry point takes ``device="cuda"`` by default and resolves it here.
There is no quiet fallback: asking for CUDA on a host without a usable CUDA
device raises, so a run that was meant for the card cannot silently measure
the CPU.  Pass ``device="cpu"`` explicitly to run on the host (the tests do).

Resolution also turns TF32 off for float32 matmuls and convolutions, so a
float32 result on the card is a float32 result, and bfloat16 reduced
precision off for bfloat16 matmuls, so their sums run in float32 as XLA's
do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> str:
    """Canonical device string (``"cpu"`` or ``"cuda"``/``"cuda:N"``).

    Returned as a string so app objects holding it stay picklable for the
    crash tester's spawned workers.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return str(dev)
