# Copy of repro/configs/qwen2_moe_a2_7b.py; unchanged.
"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4 +
4 shared experts (shared MLP width 4x1408 = 5632).

60 experts do not divide 16 -> expert weights stay replicated across "model"
and the expert FF dim (1408 = 88 x 16) is tensor-parallel instead.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151_936,
    activation="silu",
    moe=MoEConfig(
        num_experts=60, top_k=4, d_ff_expert=1408, d_ff_shared=5632,
        expert_parallel=False, dispatch_groups=32,  # §Perf: shard-local dispatch
    ),
    grad_accum=4,
)
