"""Hand-written CUDA kernels of the port, one package per kernel.

Each package has ``ops.py`` (the wrapper: checks its inputs, launches the
kernel for a CUDA tensor, runs the plain version for a CPU tensor, counts
launches) and ``ref.py`` (the plain PyTorch version).  CUDA sources live in
``csrc/`` and are compiled at first use by :mod:`._build`.

  delta_snapshot   — dirty-block detection for EasyCrash delta flushes
  flash_attention  — blockwise online-softmax attention (prefill)
  rwkv6_scan       — RWKV-6 matrix-state scan (RWKV prefill)
  rglru_scan       — RG-LRU diagonal recurrence (RecurrentGemma prefill)
"""
