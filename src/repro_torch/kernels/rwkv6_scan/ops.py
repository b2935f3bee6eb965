"""Public RWKV-6 scan ops in the model's (B, S, H, D) layout.

``rwkv6_scan`` calls the custom op ``repro_torch::rwkv6_scan``: on a CUDA
tensor the hand-written kernel in ``kernels/csrc/rwkv6_scan.cu`` (r, k, v,
w all float32 or all bfloat16, D 16, 32 or 64), or the call raises; on a
CPU tensor the plain version in :mod:`.ref`.  ``rwkv6_scan.launches``
counts kernel launches.  With ``return_state`` both also return the final
state S (B, H, D, D) f32, the leaf the decode cache holds.

``rwkv6_scan_reference`` calls ``repro_torch::rwkv6_scan_ref``, the plain
version on any device, with a backward (``repro_torch::rwkv6_scan_ref_backward``,
a reverse scan) so a model trains through it.  It is the model's
``impl="reference"``.

Each op is one dispatch with a fake implementation (its output shapes), so
a DTensor reaches it through the sharding rule in
``distributed/sharding.py`` (batch and heads split, the sequence whole) and
a meta tensor through the fake.  On a plain CUDA tensor the wrapper calls
the op's CUDA implementation itself (``kernels.direct_launch``).

``block_t`` keeps the JAX op's contract: the sequence must be a multiple of
``min(block_t, S)``.  It sets the TPU kernel's VMEM chunk; the result does
not depend on it, and the CUDA kernel does not use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from .. import _build, direct_launch, is_dtensor
from . import ref

DEFAULT_BLOCK_T = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, at a 16-byte aligned address (the kernel's bulk copies
    read 16-byte aligned rows)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(r, k, v, w, u, block_t: int) -> None:
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
    if not is_dtensor(r) and r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rwkv6_scan runs on cuda or cpu tensors, not {r.device}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T, return_state: bool = False):
    """r, k, v, w: (B, S, H, D); u: (H, D) -> y (B, S, H, D) f32, or with
    ``return_state`` (y, final state (B, H, D, D) f32)."""
    _check(r, k, v, w, u, block_t)
    run = _launch if direct_launch(r) else torch.ops.repro_torch.rwkv6_scan
    y, S = run(r, k, v, w, u, return_state)
    return (y, S) if return_state else y


rwkv6_scan.launches = 0


def rwkv6_scan_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                         u: torch.Tensor, *, return_state: bool = False):
    """The plain version as one op on any device, differentiable; the
    arguments and results of :func:`rwkv6_scan`."""
    _check(r, k, v, w, u, DEFAULT_BLOCK_T)
    y, S = torch.ops.repro_torch.rwkv6_scan_ref(r, k, v, w, u, return_state)
    return (y, S) if return_state else y


def _outputs(r: Tensor, return_state: bool) -> Tuple[Tensor, Tensor]:
    """Empty (y, S) for a call on ``r``; without ``return_state`` S is
    (B, H, 0, 0), so every output keeps its batch and head dims."""
    b, s, h, d = r.shape
    ds = d if return_state else 0
    return (r.new_empty((b, s, h, d), dtype=torch.float32),
            r.new_empty((b, h, ds, ds), dtype=torch.float32))


def _plain(r, k, v, w, u, return_state: bool) -> Tuple[Tensor, Tensor]:
    y, S = ref.rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
                               return_state=True)
    y = y.transpose(1, 2).contiguous()
    return y, (S if return_state else _outputs(r, False)[1])


def _launch(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
            return_state: bool) -> Tuple[Tensor, Tensor]:
    """The CUDA kernel (the op's CUDA implementation)."""
    b, s, h, d = r.shape
    dtypes = {x.dtype for x in (r, k, v, w)}
    if len(dtypes) > 1 or not dtypes <= _DTYPE_CODES.keys():
        raise TypeError(f"the CUDA rwkv6_scan takes r, k, v, w of one dtype, float32 or "
                        f"bfloat16, not {[x.dtype for x in (r, k, v, w)]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA rwkv6_scan takes head dims {_HEAD_DIMS}, not {d}")
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u = u.float().contiguous()
    y, S = _outputs(r, return_state)
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 y.data_ptr(), S.data_ptr() if return_state else None, b, s, h, d,
                 _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {err}")
    rwkv6_scan.launches += 1
    return y, S


_rwkv6_scan_op = torch.library.custom_op("repro_torch::rwkv6_scan", _launch, mutates_args=(),
                                         device_types="cuda")
_rwkv6_scan_op.register_kernel("cpu")(_plain)
_rwkv6_scan_op.register_fake(lambda r, k, v, w, u, return_state: _outputs(r, return_state))


@torch.library.custom_op("repro_torch::rwkv6_scan_ref", mutates_args=())
def _rwkv6_scan_ref_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                       return_state: bool) -> Tuple[Tensor, Tensor]:
    """The plain version, on any device."""
    return _plain(r, k, v, w, u, return_state)


_rwkv6_scan_ref_op.register_fake(lambda r, k, v, w, u, return_state: _outputs(r, return_state))


@torch.library.custom_op("repro_torch::rwkv6_scan_ref_backward", mutates_args=())
def _rwkv6_scan_ref_backward_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                                dy: Tensor, dS: Optional[Tensor]
                                ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dr, dk, dv, dw) (B, S, H, D) f32 and du per sequence (B, H, D) f32."""
    r, k, v, w, dy = (x.transpose(1, 2) for x in (r, k, v, w, dy))
    grads = ref.rwkv6_reference_backward(r, k, v, w, u, dy,
                                         dS if dS is not None and dS.numel() else None)
    return tuple(g.transpose(1, 2).contiguous() for g in grads[:4]) + (grads[4],)


@_rwkv6_scan_ref_backward_op.register_fake
def _(r, k, v, w, u, dy, dS):
    b, s, h, d = r.shape
    return tuple(r.new_empty((b, s, h, d), dtype=torch.float32) for _ in range(4)) + (
        r.new_empty((b, h, d), dtype=torch.float32),)


def _save(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])


def _backward(ctx, dy, dS):
    r, k, v, w, u = ctx.saved_tensors
    dr, dk, dv, dw, du = torch.ops.repro_torch.rwkv6_scan_ref_backward(r, k, v, w, u, dy, dS)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), None)


_rwkv6_scan_ref_op.register_autograd(_backward, setup_context=_save)
