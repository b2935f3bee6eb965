# Copy of repro/configs/granite_8b.py; unchanged.
"""Granite-8B-Code: llama-arch code model [arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=49_152,
    activation="silu",
    grad_accum=4,
)
