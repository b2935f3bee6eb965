from .pipeline import DataConfig, SyntheticLMStream, host_local_batch_specs

__all__ = ["DataConfig", "SyntheticLMStream", "host_local_batch_specs"]
