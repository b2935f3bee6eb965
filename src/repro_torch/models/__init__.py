# Port of repro/models/__init__.py: the names the port has (the transformer
# with its attn, rec and rwkv layer kinds and the MoE layer), plus the
# recurrent blocks' full-sequence and decode functions; param_specs,
# cache_specs and moe_specs are not ported yet (ROADMAP, module item 10).
"""Model zoo: configs + functional transformer implementation (dense GQA,
MoE, RG-LRU hybrid and RWKV-6 layer kinds)."""
from .config import (
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    RecurrentConfig,
    SHAPES,
    ShapeConfig,
    get_shape,
    scaled_down,
    shape_applicable,
)
from .moe import moe_apply, moe_params
from .rglru import rglru_decode_step, rglru_full, rglru_init_state
from .rwkv6 import rwkv_decode_step, rwkv_init_state, rwkv_scan_full
from .transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_and_aux,
    prefill,
)

__all__ = [
    "ModelConfig", "MoEConfig", "RWKVConfig", "RecurrentConfig", "SHAPES",
    "ShapeConfig", "get_shape", "scaled_down", "shape_applicable",
    "decode_step", "forward", "init_cache", "init_params", "loss_and_aux", "prefill",
    "moe_apply", "moe_params",
    "rglru_decode_step", "rglru_full", "rglru_init_state",
    "rwkv_decode_step", "rwkv_init_state", "rwkv_scan_full",
]
