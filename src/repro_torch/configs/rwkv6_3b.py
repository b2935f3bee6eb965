# Copy of repro/configs/rwkv6_3b.py; unchanged.
"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]: attention-free,
data-dependent decay, matrix-valued state per head (head_dim 64)."""
from ..models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / rwkv.head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65_536,
    activation="silu",
    rwkv=RWKVConfig(head_dim=64),
    layer_groups=((("rwkv",), 32),),
    grad_accum=2,
)
