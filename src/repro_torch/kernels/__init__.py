"""Hand-written CUDA kernels of the port, one package per kernel.

Each package has ``ops.py`` (the wrapper: checks its inputs, launches the
kernel for a CUDA tensor, runs the plain version for a CPU tensor, counts
launches) and ``ref.py`` (the plain PyTorch version).  The model kernels'
wrappers call ``torch.library`` custom ops (``repro_torch::*``), one
dispatch each with a fake implementation, so a DTensor reaches them
through a sharding rule.  CUDA sources live in ``csrc/`` and are compiled
at first use by :mod:`._build`.

  delta_snapshot   — dirty-block detection for EasyCrash delta flushes
  flash_attention  — blockwise online-softmax attention (prefill)
  rwkv6_scan       — RWKV-6 matrix-state scan (RWKV prefill)
  rglru_scan       — RG-LRU diagonal recurrence (RecurrentGemma prefill)
  ssm_update       — Mamba-2 decode state update (Granite-4.0-H decode)
"""


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (its op runs on its local shards)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def direct_launch(x) -> bool:
    """Whether a wrapper launches its kernel on ``x`` itself, without the
    custom op's dispatch (about 20 us of host time per call, which a kernel
    under 0.1 ms would wait on): a plain CUDA tensor with no dispatch mode
    active.  A DTensor, a fake or meta tensor, or a counting mode takes the
    op, whose CUDA implementation is the same launch."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return type(x) is torch.Tensor and x.is_cuda and _get_current_dispatch_mode() is None
