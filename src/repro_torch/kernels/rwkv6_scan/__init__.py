from .ops import rwkv6_scan

__all__ = ["rwkv6_scan"]
