# Copy of repro/configs/minitron_8b.py; unchanged.
"""Minitron-8B: width-pruned Nemotron-4 [arXiv:2407.14679; hf:nvidia/Minitron-8B-Base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=256_000,
    activation="relu2",     # squared ReLU, inherited from Nemotron-4
    grad_accum=8,           # 256k vocab: bound microbatch logits
)
