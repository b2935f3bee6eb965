from .ops import dirty_block_mask

__all__ = ["dirty_block_mask"]
