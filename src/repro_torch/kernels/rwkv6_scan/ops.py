"""Public RWKV-6 scan op in the model's (B, S, H, D) layout.

A CUDA tensor goes to the hand-written kernel in
``kernels/csrc/rwkv6_scan.cu`` (r, k, v, w all float32 or all bfloat16,
D 16, 32 or 64) or the call raises; a CPU tensor goes to the plain version in
:mod:`.ref`.  ``rwkv6_scan.launches`` counts kernel launches.  With
``return_state`` both also return the final state S (B, H, D, D) f32, the
leaf the decode cache holds.

``block_t`` keeps the JAX op's contract: the sequence must be a multiple of
``min(block_t, S)``.  It sets the TPU kernel's VMEM chunk; the result does
not depend on it, and the CUDA kernel does not use it.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rwkv6_reference

DEFAULT_BLOCK_T = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, at a 16-byte aligned address (the kernel's bulk copies
    read 16-byte aligned rows)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T, return_state: bool = False):
    """r, k, v, w: (B, S, H, D); u: (H, D) -> y (B, S, H, D) f32, or with
    ``return_state`` (y, final state (B, H, D, D) f32)."""
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"r, k, v, w must share one (B, S, H, D) shape, got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, s, h, d = r.shape
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u must be (H, D) = {(h, d)}, got {tuple(u.shape)}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("r, k, v, w, u must share one device")
    bt = min(block_t, s)
    if bt < 1 or s % bt:
        raise ValueError(f"sequence {s} is not a multiple of the block {bt}")
    if r.device.type == "cpu":
        y, S = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u, return_state=True)
        y = y.transpose(1, 2).contiguous()
        return (y, S) if return_state else y
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu tensors, not {r.device}")
    dtypes = {x.dtype for x in (r, k, v, w)}
    if len(dtypes) > 1 or not dtypes <= _DTYPE_CODES.keys():
        raise TypeError(f"the CUDA rwkv6_scan takes r, k, v, w of one dtype, float32 or "
                        f"bfloat16, not {[x.dtype for x in (r, k, v, w)]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA rwkv6_scan takes head dims {_HEAD_DIMS}, not {d}")
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u = u.float().contiguous()
    y = torch.empty((b, s, h, d), dtype=torch.float32, device=r.device)
    S = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
         if return_state else None)
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 y.data_ptr(), None if S is None else S.data_ptr(), b, s, h, d,
                 _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {err}")
    rwkv6_scan.launches += 1
    return (y, S) if return_state else y


rwkv6_scan.launches = 0
