# Copy of repro/configs/internvl2_76b.py; unchanged.
"""InternVL2-Llama3-76B [arXiv:2404.16821; unverified]: InternViT-6B vision
frontend (STUB: input_specs supplies 256 pre-projected patch embeddings per
image) + Llama-3-70B-class language backbone."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=128_256,
    activation="silu",
    frontend_tokens=256,
    moment_dtype="bfloat16",
    grad_accum=16,
)
