"""Paged KV cache: block pool, per-request manager and device pools."""

from .block_pool import BlockPool, KVCacheBlock
from .manager import KVCacheManager
from .paged import PagedKVCache

__all__ = ["BlockPool", "KVCacheBlock", "KVCacheManager", "PagedKVCache"]
