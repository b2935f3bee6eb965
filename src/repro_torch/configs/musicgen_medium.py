# Copy of repro/configs/musicgen_medium.py; unchanged.
"""MusicGen-medium: decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284; hf:facebook/musicgen-medium].

Backbone only: the EnCodec frontend is a stub — inputs are code-book token
ids (vocab 2048).  24 heads = MHA (kv == q heads).  24 heads do not divide a
16-way TP axis: baseline takes GSPMD padding on the head dim (flagged in
EXPERIMENTS.md §Perf as a hillclimb target).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab=2048,
    activation="gelu",
    grad_accum=1,
)
