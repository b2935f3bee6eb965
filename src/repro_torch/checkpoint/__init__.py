from .manager import (
    CheckpointConfig,
    CheckpointManager,
    measure_checkpoint_cost,
    measured_system_config,
    system_config_from_measurement,
)
from .serialization import load_pytree, save_pytree, tree_nbytes
from .reshard import reshard_restore

__all__ = [
    "CheckpointConfig", "CheckpointManager", "load_pytree", "save_pytree",
    "tree_nbytes", "measure_checkpoint_cost", "measured_system_config",
    "system_config_from_measurement", "reshard_restore",
]
