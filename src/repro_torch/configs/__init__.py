# Copy of repro/configs/__init__.py; unchanged.
"""Assigned architecture configs (one module per arch) + registry."""
from typing import Dict

from ..models.config import ModelConfig
from .musicgen_medium import CONFIG as musicgen_medium
from .minitron_8b import CONFIG as minitron_8b
from .granite_8b import CONFIG as granite_8b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .rwkv6_3b import CONFIG as rwkv6_3b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from .internvl2_76b import CONFIG as internvl2_76b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c.validate()
    for c in (
        musicgen_medium,
        minitron_8b,
        granite_8b,
        stablelm_1_6b,
        nemotron_4_340b,
        recurrentgemma_9b,
        rwkv6_3b,
        llama4_scout_17b_a16e,
        qwen2_moe_a2_7b,
        internvl2_76b,
    )
}


def get_arch(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    for k, v in ARCHS.items():
        if k == key or k.replace("-", "_") == name:
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def arch_names():
    return sorted(ARCHS)
