"""Public RG-LRU scan ops.

``rglru_scan`` calls the custom op ``repro_torch::rglru_scan``: on a CUDA
tensor the hand-written kernel in ``kernels/csrc/rglru_scan.cu`` (a and b
both float32 or both bfloat16), or the call raises; on a CPU tensor the
plain version in :mod:`.ref`.  ``rglru_scan.launches`` counts kernel
launches.  The kernel feeds its chains from a ring filled by the TMA engine
where rows of D elements are 16-byte aligned, and reads directly otherwise;
both give the plain version's bits.  The last step ``h[:, -1]`` is the
decode cache's state.

``rglru_scan_reference`` calls ``repro_torch::rglru_scan_ref``, the plain
version on any device, with a backward (``repro_torch::rglru_scan_ref_backward``,
a reverse scan) so a model trains through it.  It is the model's
``impl="reference"`` and ``impl="chunked"``.

Each op is one dispatch with a fake implementation (its output shape), so
a DTensor reaches it through the sharding rule in
``distributed/sharding.py`` (batch and channels split, the sequence whole)
and a meta tensor through the fake.  On a plain CUDA tensor the wrapper
calls the op's CUDA implementation itself (``kernels.direct_launch``).

``block_t`` and ``block_d`` keep the JAX op's contract: T must be a
multiple of ``min(block_t, T)`` and D of ``min(block_d, D)``.  They set the
TPU kernel's VMEM tiles; the result does not depend on them, and the CUDA
kernel does not use them.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from .. import _build, direct_launch, is_dtensor
from . import ref

DEFAULT_BLOCK_T = 256
DEFAULT_BLOCK_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, b, block_t: int, block_d: int) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must share one (B, T, D) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b must share one device")
    _, t, d = a.shape
    bt, bd = min(block_t, t), min(block_d, d)
    if bt < 1 or bd < 1 or t % bt or d % bd:
        raise ValueError(f"(T, D) = {(t, d)} is not a multiple of the blocks {(bt, bd)}")
    if not is_dtensor(a) and a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {a.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T,
               block_d: int = DEFAULT_BLOCK_D) -> torch.Tensor:
    """a, b: (B, T, D) gates/inputs -> hidden states (B, T, D) f32."""
    _check(a, b, block_t, block_d)
    return (_launch if direct_launch(a) else torch.ops.repro_torch.rglru_scan)(a, b)


rglru_scan.launches = 0


def rglru_scan_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version as one op on any device, differentiable."""
    _check(a, b, DEFAULT_BLOCK_T, DEFAULT_BLOCK_D)
    return torch.ops.repro_torch.rglru_scan_ref(a, b)


def _fake(a, b):
    return a.new_empty(a.shape, dtype=torch.float32)


def _launch(a: Tensor, b: Tensor) -> Tensor:
    """The CUDA kernel (the op's CUDA implementation)."""
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA rglru_scan takes a and b of one dtype, float32 or bfloat16, "
                        f"not {a.dtype}, {b.dtype}")
    bsz, t, d = a.shape
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


_rglru_scan_op = torch.library.custom_op("repro_torch::rglru_scan", _launch, mutates_args=(),
                                         device_types="cuda")
_rglru_scan_op.register_kernel("cpu")(lambda a, b: ref.rglru_reference(a, b))
_rglru_scan_op.register_fake(_fake)


@torch.library.custom_op("repro_torch::rglru_scan_ref", mutates_args=())
def _rglru_scan_ref_op(a: Tensor, b: Tensor) -> Tensor:
    """The plain version, on any device."""
    return ref.rglru_reference(a, b)


_rglru_scan_ref_op.register_fake(_fake)


@torch.library.custom_op("repro_torch::rglru_scan_ref_backward", mutates_args=())
def _rglru_scan_ref_backward_op(a: Tensor, b: Tensor, dh: Tensor) -> Tuple[Tensor, Tensor]:
    """(da, db), each (B, T, D) f32."""
    return ref.rglru_reference_backward(a, b, dh)


_rglru_scan_ref_backward_op.register_fake(lambda a, b, dh: (_fake(a, b), _fake(a, b)))


def _save(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dh):
    a, b = ctx.saved_tensors
    da, db = torch.ops.repro_torch.rglru_scan_ref_backward(a, b, dh)
    return da.to(a.dtype), db.to(b.dtype)


_rglru_scan_ref_op.register_autograd(_backward, setup_context=_save)
