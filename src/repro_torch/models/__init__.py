# Port of repro/models/__init__.py: the names the port has (the transformer
# with its attn, rec and rwkv layer kinds), plus the recurrent blocks'
# full-sequence and decode functions; param_specs and cache_specs are not
# ported yet (ROADMAP, module item 10).
"""Model zoo: configs + functional transformer implementation (dense GQA,
RG-LRU hybrid and RWKV-6 layer kinds)."""
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
    "rglru_decode_step", "rglru_full", "rglru_init_state",
    "rwkv_decode_step", "rwkv_init_state", "rwkv_scan_full",
]
