# Port of repro/models/__init__.py: the same names, plus the MoE layer and
# the recurrent blocks' full-sequence and decode functions.
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
from .moe import moe_apply, moe_params, moe_specs
from .rglru import rglru_decode_step, rglru_full, rglru_init_state
from .rwkv6 import rwkv_decode_step, rwkv_init_state, rwkv_scan_full
from .transformer import (
    cache_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_and_aux,
    param_specs,
    prefill,
)

__all__ = [
    "ModelConfig", "MoEConfig", "RWKVConfig", "RecurrentConfig", "SHAPES",
    "ShapeConfig", "get_shape", "scaled_down", "shape_applicable",
    "cache_specs", "decode_step", "forward", "init_cache", "init_params",
    "loss_and_aux", "param_specs", "prefill",
    "moe_apply", "moe_params", "moe_specs",
    "rglru_decode_step", "rglru_full", "rglru_init_state",
    "rwkv_decode_step", "rwkv_init_state", "rwkv_scan_full",
]
