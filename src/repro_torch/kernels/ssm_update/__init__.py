from .ops import ssm_update

__all__ = ["ssm_update"]
