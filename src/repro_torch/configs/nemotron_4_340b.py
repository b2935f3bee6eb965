# Copy of repro/configs/nemotron_4_340b.py; unchanged.
"""Nemotron-4-340B [arXiv:2402.16819; unverified]: GQA kv=8, squared ReLU.

The heavyweight cell: params+moments only fit a 256-chip v5e pod with
bf16 Adam moments and full FSDPxTP sharding; activations need microbatched
gradient accumulation (grad_accum=16 -> 16 sequences per microbatch).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab=256_000,
    activation="relu2",
    moment_dtype="bfloat16",
    grad_accum=16,
)
