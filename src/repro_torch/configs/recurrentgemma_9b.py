# Copy of repro/configs/recurrentgemma_9b.py; unchanged.
"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified]: RG-LRU + local
attention, pattern (rec, rec, attn) with a trailing (rec, rec); window 2048.

38 layers = 12 x (rec, rec, attn) + 1 x (rec, rec).
"""
from ..models.config import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256_000,
    activation="gelu",
    rec=RecurrentConfig(d_rnn=4096, conv_width=4, window=2048),
    layer_groups=((("rec", "rec", "attn"), 12), (("rec", "rec"), 1)),
    attn_window=2048,
    grad_accum=8,
)
