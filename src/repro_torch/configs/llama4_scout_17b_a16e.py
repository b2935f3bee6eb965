# Copy of repro/configs/llama4_scout_17b_a16e.py; unchanged.
"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
MoE 16 experts top-1 + shared expert, every layer MoE; early-fusion backbone.

16 experts divide the 16-way model axis exactly -> expert parallelism.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202_048,
    activation="silu",
    moe=MoEConfig(
        num_experts=16, top_k=1, d_ff_expert=8192, d_ff_shared=8192,
        expert_parallel=True, dispatch_groups=32,  # §Perf: shard-local dispatch
    ),
    grad_accum=8,
)
