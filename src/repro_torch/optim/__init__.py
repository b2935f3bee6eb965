# Port of repro/optim/__init__.py: the same exports, less opt_state_specs
# and the OptState marker (sharding; ROADMAP, module item 10), plus
# AdamWConfig.
from .adamw import AdamWConfig, adamw_init, adamw_update
from .schedule import cosine_schedule, linear_warmup
from .compression import compress_topk, decompress_topk, quantize_int8, dequantize_int8

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "linear_warmup",
    "compress_topk", "decompress_topk", "quantize_int8", "dequantize_int8",
]
