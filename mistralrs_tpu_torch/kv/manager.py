"""Per-request block-table management (a copy of ``mistralrs_tpu/kv/manager.py``
without the data-parallel grouped manager; the analog of the reference's
``KVCacheManager``, ``paged_attention/kv_cache_manager.rs:43``): prefix-cache
lookup on admission, slot allocation as decoding proceeds, and
slot-mapping/block-table construction for the kernels."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .block_pool import BlockPool, KVCacheBlock, hash_block_tokens


@dataclass
class RequestBlocks:
    blocks: list[KVCacheBlock] = field(default_factory=list)
    num_cached_tokens: int = 0  # tokens covered by prefix-cache hits
    hashes: list[int] = field(default_factory=list)  # chained block hashes
    num_cached_blocks: int = 0  # blocks already published to the prefix cache


class KVCacheManager:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
    ):
        self.block_size = block_size
        self.pool = BlockPool(num_blocks, enable_prefix_caching)
        self._requests: dict[str, RequestBlocks] = {}

    # data-parallel group interface (trivial for the single-group manager;
    # see GroupedKVManager)
    def assign_group(self, request_id: str, allowed=None) -> int:
        return 0

    def group_of(self, request_id: str) -> int:
        return 0

    # -- admission ----------------------------------------------------------

    def get_computed_blocks(
        self, request_id: str, token_ids: Sequence[int], extra: tuple = ()
    ) -> int:
        """Find the longest cached prefix (full blocks only, never the whole
        prompt — at least one token must be recomputed to produce logits).
        Returns the number of cached tokens; the hit blocks are recorded (but
        not yet ref-counted — `allocate_slots` takes ownership)."""
        bs = self.block_size
        st = self._requests.setdefault(request_id, RequestBlocks())
        n_full = len(token_ids) // bs
        hashes: list[int] = []
        parent = None
        for i in range(n_full):
            h = hash_block_tokens(parent, token_ids[i * bs : (i + 1) * bs], extra)
            hashes.append(h)
            parent = h
        st.hashes = hashes
        hits: list[KVCacheBlock] = []
        for h in hashes:
            b = self.pool.get_cached_block(h)
            if b is None:
                break
            hits.append(b)
        # never serve the entire prompt from cache
        if hits and len(hits) * bs >= len(token_ids):
            hits.pop()
        st.blocks = hits
        st.num_cached_tokens = len(hits) * bs
        st.num_cached_blocks = len(hits)
        return st.num_cached_tokens

    def allocate_slots(
        self,
        request_id: str,
        num_tokens_total: int,
    ) -> bool:
        """Ensure the request has blocks covering ``num_tokens_total`` tokens.
        On first call, takes ownership (touch) of prefix-hit blocks. Returns
        False (allocating nothing) if the pool cannot satisfy the request."""
        st = self._requests.setdefault(request_id, RequestBlocks())
        bs = self.block_size
        needed_blocks = -(-num_tokens_total // bs)
        have = len(st.blocks)
        if not getattr(st, "_owned", False):
            self.pool.touch(st.blocks)
            st._owned = True  # type: ignore[attr-defined]
        new = needed_blocks - have
        if new <= 0:
            return True
        if new > self.pool.num_free_blocks:
            return False
        st.blocks.extend(self.pool.allocate(new))
        return True

    def can_allocate(self, num_new_blocks: int) -> bool:
        return num_new_blocks <= self.pool.num_free_blocks

    # -- progress / publication --------------------------------------------

    def publish_full_blocks(self, request_id: str, num_computed_tokens: int) -> None:
        """Publish blocks that are now fully written to the prefix cache."""
        st = self._requests.get(request_id)
        if st is None:
            return
        bs = self.block_size
        full = num_computed_tokens // bs
        for i in range(st.num_cached_blocks, min(full, len(st.hashes), len(st.blocks))):
            self.pool.cache_block(st.blocks[i], st.hashes[i])
        st.num_cached_blocks = max(st.num_cached_blocks, min(full, len(st.hashes)))

    def extend_hashes(self, request_id: str, token_ids: Sequence[int]) -> None:
        """Extend the hash chain as generated tokens complete new blocks."""
        st = self._requests.get(request_id)
        if st is None:
            return
        bs = self.block_size
        n_full = len(token_ids) // bs
        parent = st.hashes[-1] if st.hashes else None
        for i in range(len(st.hashes), n_full):
            h = hash_block_tokens(parent, token_ids[i * bs : (i + 1) * bs])
            st.hashes.append(h)
            parent = h

    # -- kernel-facing views -------------------------------------------------

    def block_table(self, request_id: str) -> list[int]:
        return [b.block_id for b in self._requests[request_id].blocks]

    def num_cached_tokens(self, request_id: str) -> int:
        st = self._requests.get(request_id)
        return st.num_cached_tokens if st else 0

    def slot_mapping(self, request_id: str, start: int, length: int) -> np.ndarray:
        """Physical slot index for logical token positions [start, start+len)."""
        st = self._requests[request_id]
        bs = self.block_size
        pos = np.arange(start, start + length)
        block_ids = np.asarray([b.block_id for b in st.blocks])
        return block_ids[pos // bs] * bs + pos % bs

    # -- teardown -----------------------------------------------------------

    def free(self, request_id: str) -> None:
        st = self._requests.pop(request_id, None)
        if st is not None and getattr(st, "_owned", False):
            self.pool.free(st.blocks)

    @property
    def num_free_blocks(self) -> int:
        return self.pool.num_free_blocks

