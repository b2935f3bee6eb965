"""Public flash-attention op in the model's (B, S, H, D) layout.

``flash_attention`` calls the custom op ``repro_torch::flash_attention``:
on a CUDA tensor the hand-written kernels in
``kernels/csrc/flash_attention.cu`` (D 64, 128 or 256; a smaller D runs as
64, q, k and v padded with zero columns, which add nothing to a score, and
the output's extra columns dropped), or the call raises; on a CPU tensor
the plain version in :mod:`.ref`.  The op is one dispatch with a fake
implementation, so a DTensor reaches it through the sharding rule in
``distributed/sharding.py`` (batch and heads split, the sequence whole); on
a plain CUDA tensor the wrapper calls the op's CUDA implementation itself
(``kernels.direct_launch``).
``flash_attention.launches`` counts kernel launches.

Two routes on the card, chosen by dtype (:func:`kernel_route`):

- bfloat16, the serving path: a persistent ``wgmma`` kernel fed by TMA, one
  CTA per SM.  Its q tile is 128 rows (two consumer warpgroups); its kv tile
  and ring depth depend on D alone (:data:`BF16_TILES`, which mirrors the
  source's ``Bf16Tiles``).  Its operands must start 16 bytes aligned, as a
  TMA tensor map needs: a view that does not is copied first.
- float32, the parity checks: the SIMT kernel (f32 FMAs; tensor cores would
  round to TF32).  Its q tile is 64 rows; its kv tile is ``block_k`` where
  that is 32 or 64, and 64 for anything larger (a 128-row f32 k and v tile
  at D 256 is 256 KiB, more than a CTA's shared memory).

``block_q`` and ``block_k`` keep the JAX op's contract: the sequence must be
a multiple of ``min(block, S)``.  They pick no tile of the bf16 route.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .. import _build, direct_launch, is_dtensor
from . import ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
#: the bf16 route's q tile rows, and its (kv tile rows, ring stages) per D
BF16_Q_ROWS = 128
BF16_TILES = {64: (128, 3), 128: (128, 2), 256: (64, 2)}
#: shared memory a CTA may use on sm_90 (227 KiB)
SMEM_LIMIT = 232448


def kernel_route(dtype: torch.dtype, d: int, block_k: int) -> dict:
    """Which kernel a CUDA call with this dtype, head dim and ``block_k``
    takes, with its tiles and shared-memory bytes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA flash_attention takes float32 or bfloat16, not {dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash_attention takes head dims {_HEAD_DIMS}, not {d}")
    if dtype == torch.bfloat16:
        kv, stages = BF16_TILES[d]
        # q tile, then K and V per stage, 2 bytes each; barriers; 1 KiB of
        # slack to align the 128-byte-swizzled tiles to 1024 bytes
        smem = 2 * d * (BF16_Q_ROWS + 2 * stages * kv) + 8 * (2 * stages + 4) + 1024
        return {"route": "wgmma", "q_rows": BF16_Q_ROWS, "kv_tile": kv, "stages": stages,
                "smem_bytes": smem}
    kv = 32 if block_k <= 32 else 64
    smem = 4 * (64 * (d + 1) + kv * (d + 1) + kv * d + 64 * (kv + 1) + 3 * 64)
    return {"route": "simt", "q_rows": 64, "kv_tile": kv, "stages": 1, "smem_bytes": smem}


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs a call of head dim ``d`` at."""
    return max(d, _HEAD_DIMS[0])


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as a TMA tensor map
    needs (a view into a larger buffer may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: Optional[int] = None,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v: (B, S, H, D) (same head counts: repeat GQA upstream); the
    scores are scaled by ``scale``, by default ``D ** -0.5``."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must share one dtype and device")
    s = q.shape[1]
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"sequence {s} is not a multiple of the blocks ({bq}, {bk})")
    if not is_dtensor(q) and q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    run = _launch if direct_launch(q) else torch.ops.repro_torch.flash_attention
    return run(q, k, v, causal, window or 0, bk, scale)


flash_attention.launches = 0


def _launch(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
            block_k: int, scale: Optional[float] = None) -> Tensor:
    """The CUDA kernels (``window`` 0: none; ``scale`` None: ``D ** -0.5``;
    the op's CUDA implementation)."""
    b, s, h, d = q.shape
    dk = kernel_head_dim(d)
    route = kernel_route(q.dtype, dk, block_k)
    if dk != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    out = torch.empty_like(q)
    scale = float(np.float32(d ** -0.5 if scale is None else scale))
    fn = _build.load("flash_attention").flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, dk,
                 int(causal), window, route["kv_tile"], scale, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out[..., :d] if dk != d else out


_flash_attention_op = torch.library.custom_op("repro_torch::flash_attention", _launch,
                                              mutates_args=(), device_types="cuda")


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, causal, window, block_k, scale=None):
    out = ref.attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window or None, scale=scale)
    return out.transpose(1, 2)


_flash_attention_op.register_fake(
    lambda q, k, v, causal, window, block_k, scale=None: torch.empty_like(q))
