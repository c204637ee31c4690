"""Ref-counted KV block pool with content-addressed prefix caching (a copy
of ``mistralrs_tpu/kv/block_pool.py``).

Re-implements the invariants of the reference's `BlockPool`
(`mistralrs-core/src/paged_attention/block_pool.rs:267`): blocks carry a
ref-count and an optional content hash; fully-written blocks are published to
a hash→block map; the free list is LRU so cached blocks survive as long as
memory allows; eviction removes the hash entry lazily on reuse.

Block hashes chain parent→child (`block_hash.rs`): hash(block) =
H(parent_hash, tokens[, extra media/adapter keys]), so a hit on block i
implies hits on all ancestors.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence


def hash_block_tokens(
    parent_hash: Optional[int], tokens: Sequence[int], extra: tuple = ()
) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(repr((parent_hash, tuple(tokens), extra)).encode())
    return int.from_bytes(h.digest(), "little")


@dataclass
class KVCacheBlock:
    block_id: int
    ref_count: int = 0
    block_hash: Optional[int] = None


class BlockPool:
    """Fixed set of physical KV blocks with LRU free list + prefix cache."""

    def __init__(self, num_blocks: int, enable_prefix_caching: bool = True):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        self.blocks = [KVCacheBlock(i) for i in range(num_blocks)]
        # LRU free queue: ordered dict block_id → block (front = oldest)
        self._free: OrderedDict[int, KVCacheBlock] = OrderedDict(
            (b.block_id, b) for b in self.blocks
        )
        self._hash_to_block: dict[int, KVCacheBlock] = {}

    # -- queries ------------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    def get_cached_block(self, block_hash: int) -> Optional[KVCacheBlock]:
        if not self.enable_prefix_caching:
            return None
        b = self._hash_to_block.get(block_hash)
        if b is None:
            return None
        # a cached block may be in the free queue (ref 0) — revivable
        return b

    # -- allocation ---------------------------------------------------------

    def allocate(self, n: int) -> list[KVCacheBlock]:
        """Take n blocks from the free list (evicting their cache entries)."""
        if n > len(self._free):
            raise RuntimeError(f"out of KV blocks: need {n}, free {len(self._free)}")
        out = []
        for _ in range(n):
            _, b = self._free.popitem(last=False)  # oldest first
            if b.block_hash is not None:
                # lazy eviction of the prefix-cache entry
                if self._hash_to_block.get(b.block_hash) is b:
                    del self._hash_to_block[b.block_hash]
                b.block_hash = None
            b.ref_count = 1
            out.append(b)
        return out

    def touch(self, blocks: Sequence[KVCacheBlock]) -> None:
        """Increase ref-count; revive from the free queue if needed."""
        for b in blocks:
            if b.ref_count == 0:
                self._free.pop(b.block_id, None)
            b.ref_count += 1

    def free(self, blocks: Sequence[KVCacheBlock]) -> None:
        """Decrease ref-count; at zero, return to the free queue (MRU end —
        most recently used blocks are evicted last)."""
        for b in blocks:
            if b.ref_count <= 0:
                raise RuntimeError(f"double free of block {b.block_id}")
            b.ref_count -= 1
            if b.ref_count == 0:
                self._free[b.block_id] = b

    # -- prefix caching -----------------------------------------------------

    def cache_block(self, block: KVCacheBlock, block_hash: int) -> None:
        """Publish a fully-written block under its content hash."""
        if not self.enable_prefix_caching:
            return
        old = self._hash_to_block.get(block_hash)
        if old is not None and old is not block:
            # keep the existing entry (dedup would require copy-on-write)
            return
        block.block_hash = block_hash
        self._hash_to_block[block_hash] = block

    def reset_prefix_cache(self) -> bool:
        """Drop all cache entries (only when nothing is referenced)."""
        if any(b.ref_count > 0 for b in self.blocks):
            return False
        self._hash_to_block.clear()
        for b in self.blocks:
            b.block_hash = None
        return True
