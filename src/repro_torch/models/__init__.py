# Port of repro/models/__init__.py: the names the port has (the dense
# transformer path); loss_and_aux, param_specs and cache_specs are not
# ported yet (ROADMAP, module items 6 and 10).
"""Model zoo: configs + functional transformer implementation."""
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
from .transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "ModelConfig", "MoEConfig", "RWKVConfig", "RecurrentConfig", "SHAPES",
    "ShapeConfig", "get_shape", "scaled_down", "shape_applicable",
    "decode_step", "forward", "init_cache", "init_params", "prefill",
]
