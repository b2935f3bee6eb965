# Copy of repro/configs/stablelm_1_6b.py; unchanged.
"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].  MHA (kv=32)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100_352,
    activation="silu",
    grad_accum=2,
)
