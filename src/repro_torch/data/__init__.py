# Port of repro/data/__init__.py, less host_local_batch_specs (ROADMAP,
# module item 10).
from .pipeline import DataConfig, SyntheticLMStream

__all__ = ["DataConfig", "SyntheticLMStream"]
