# Port of repro/checkpoint/__init__.py, less reshard_restore: reshard.py
# places a tree onto a JAX device mesh, and waits for the mesh and sharding
# layer (ROADMAP, module item 10).
from .manager import (
    CheckpointConfig,
    CheckpointManager,
    measure_checkpoint_cost,
    measured_system_config,
    system_config_from_measurement,
)
from .serialization import load_pytree, save_pytree, tree_nbytes

__all__ = [
    "CheckpointConfig", "CheckpointManager", "load_pytree", "save_pytree",
    "tree_nbytes", "measure_checkpoint_cost", "measured_system_config",
    "system_config_from_measurement",
]
