# Port of repro/optim/__init__.py: the same exports, plus AdamWConfig.
from .adamw import AdamWConfig, OptState, adamw_init, adamw_update, opt_state_specs
from .schedule import cosine_schedule, linear_warmup
from .compression import compress_topk, decompress_topk, quantize_int8, dequantize_int8

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update", "opt_state_specs",
    "cosine_schedule", "linear_warmup",
    "compress_topk", "decompress_topk", "quantize_int8", "dequantize_int8",
]
