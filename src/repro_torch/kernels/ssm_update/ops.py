"""Public Mamba-2 decode state update: ``ssm_update(h, x, dt, A, B, C, D)``.

A CUDA tensor goes to the hand-written kernel in
``kernels/csrc/ssm_update.cu`` (float32, contiguous, the state 16-byte
aligned with ``N`` a multiple of 4), or the call raises; a CPU tensor goes
to the plain version in :mod:`.ref`.  ``ssm_update.launches`` counts kernel
launches.  The state ``h`` is updated in place (a decode cache's leaf).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import ssm_update_reference


def _check(h, x, dt, A, B, C, D) -> None:
    if h.dim() != 4:
        raise ValueError(f"h must be (Bt, H, P, N), got {tuple(h.shape)}")
    bt, nh, p, n = h.shape
    g = B.shape[1] if B.dim() == 3 else 0
    want = {"x": (bt, nh, p), "dt": (bt, nh), "A": (nh,), "B": (bt, g, n), "C": (bt, g, n),
            "D": (nh,)}
    for name, t in zip(("x", "dt", "A", "B", "C", "D"), (x, dt, A, B, C, D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if g < 1 or nh % g:
        raise ValueError(f"the groups ({g}) must divide the heads ({nh})")
    if any(t.device != h.device for t in (x, dt, A, B, C, D)):
        raise ValueError("ssm_update's tensors must share one device")


def ssm_update(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """h (Bt, H, P, N) updated in place; returns y (Bt, H, P).  See
    :func:`.ref.ssm_update_reference` for the arithmetic."""
    _check(h, x, dt, A, B, C, D)
    if h.device.type == "cpu":
        return ssm_update_reference(h, x, dt, A, B, C, D)
    if h.device.type != "cuda":
        raise ValueError(f"ssm_update runs on cuda or cpu tensors, not {h.device}")
    ts = (h, x, dt, A, B, C, D)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the CUDA ssm_update takes float32 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA ssm_update takes contiguous tensors")
    bt, nh, p, n = h.shape
    if n % 4 or h.data_ptr() % 16 or n > 512:
        raise ValueError("the CUDA ssm_update takes N a multiple of 4, at most 512, and a "
                         "16-byte aligned state")
    y = torch.empty((bt, nh, p), dtype=torch.float32, device=h.device)
    if h.numel() == 0:
        return y
    fn = _build.load("ssm_update").ssm_update_fwd
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(), y.data_ptr(), bt, nh, p, n, B.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"ssm_update kernel launch failed: CUDA error {err}")
    ssm_update.launches += 1
    return y


ssm_update.launches = 0
