"""Public RG-LRU scan op.

A CUDA tensor goes to the hand-written kernel in
``kernels/csrc/rglru_scan.cu`` (a and b both float32 or both bfloat16)
or the call raises; a CPU tensor goes to the plain version in :mod:`.ref`.
``rglru_scan.launches`` counts kernel launches.  The kernel feeds its
chains from a ring filled by the TMA engine where rows of D elements are
16-byte aligned, and reads directly otherwise; both give the plain
version's bits.  The last step ``h[:, -1]`` is the decode cache's state.

``block_t`` and ``block_d`` keep the JAX op's contract: T must be a
multiple of ``min(block_t, T)`` and D of ``min(block_d, D)``.  They set the
TPU kernel's VMEM tiles; the result does not depend on them, and the CUDA
kernel does not use them.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rglru_reference

DEFAULT_BLOCK_T = 256
DEFAULT_BLOCK_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T,
               block_d: int = DEFAULT_BLOCK_D) -> torch.Tensor:
    """a, b: (B, T, D) gates/inputs -> hidden states (B, T, D) f32."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must share one (B, T, D) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b must share one device")
    bsz, t, d = a.shape
    bt, bd = min(block_t, t), min(block_d, d)
    if bt < 1 or bd < 1 or t % bt or d % bd:
        raise ValueError(f"(T, D) = {(t, d)} is not a multiple of the blocks {(bt, bd)}")
    if a.device.type == "cpu":
        return rglru_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA rglru_scan takes a and b of one dtype, float32 or bfloat16, "
                        f"not {a.dtype}, {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    h = torch.empty((bsz, t, d), dtype=torch.float32, device=a.device)
    fn = _build.load("rglru_scan").rglru_scan_fwd
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, t, d, _DTYPE_CODES[a.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
