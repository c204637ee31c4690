"""Device-side paged KV cache pools and their write/gather ops (counterpart
of ``mistralrs_tpu/kv/paged.py``).

Layout: one head-major pool per K and V, ``[L, n_kv, (num_blocks + 1) *
block_size, head_dim]`` bf16, so one (head, block) stripe is contiguous and a
slot is ``block * block_size + row``. The extra block at the end is the trash
block: writes with slot < 0 land there (``write_kv``) or are dropped (the
kernels), and no block table ever points at it. Quantized (int8/fp8) pools
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import torch

from .._device import DeviceLike, resolve_device

if TYPE_CHECKING:  # the model package imports this module
    from ..models.config import ModelConfig


@dataclass
class PagedKVCache:
    """k/v pools: [L, n_kv, S_total(slots), head_dim]; updated in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        num_blocks: int,
        block_size: int,
        dtype=torch.bfloat16,
        kv_quant: Optional[str] = None,
        device: DeviceLike = None,
    ) -> "PagedKVCache":
        """Zeroed pools on ``device`` (``cuda`` unless the caller asks for
        ``"cpu"``)."""
        device = resolve_device(device)
        if kv_quant is not None:
            raise NotImplementedError("quantized KV pools are not ported yet")
        # +1 trash block: dropped writes (slot −1) go there, never to a live slot
        slots = (num_blocks + 1) * block_size
        shape = (cfg.num_layers, cfg.num_kv_heads, slots, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def write_kv(
    cache_k: torch.Tensor,  # [n_kv, S_total, hd] (one layer), updated in place
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # [T, n_kv, hd]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [T] int physical slot ids; negative → trash
) -> None:
    """reshape_and_cache: scatter new KV rows into the pool. Rows with
    slot < 0 land in the trash block's last slot."""
    trash = cache_k.shape[1] - 1
    safe = torch.where(slots < 0, torch.full_like(slots, trash), slots).to(
        device=cache_k.device, dtype=torch.long)
    cache_k[:, safe] = k_new.transpose(0, 1).to(cache_k.dtype)
    cache_v[:, safe] = v_new.transpose(0, 1).to(cache_v.dtype)


def gather_kv(
    cache_k: torch.Tensor,  # [n_kv, S_total, hd]
    cache_v: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int (−1 padding allowed)
    block_size: int,
    dtype=torch.bfloat16,
):
    """Per-sequence KV [B, max_blocks * block_size, n_kv, hd] gathered from
    the pool (validity masked downstream by kv_len)."""
    bt = block_table.clamp_min(0).to(device=cache_k.device, dtype=torch.long)
    slots = (bt[:, :, None] * block_size
             + torch.arange(block_size, device=bt.device)).reshape(bt.shape[0], -1)
    k = cache_k[:, slots]  # [n_kv, B, S, hd]
    v = cache_v[:, slots]
    return k.permute(1, 2, 0, 3).to(dtype), v.permute(1, 2, 0, 3).to(dtype)


def calculate_cache_config(
    cfg: ModelConfig,
    *,
    block_size: int = 64,
    max_model_len: int,
    max_batch: int,
    kv_quant: bool = False,
    dtype=torch.bfloat16,
    utilization: float = 0.90,
    weight_bytes: int | None = None,
    mem_bytes: int | None = None,
    device: torch.device | str = "cuda",
    bytes_per_token: int | None = None,
) -> int:
    """Memory-utilization-driven KV pool sizing (the analog of the reference's
    ``calculate_cache_config``): fill ``utilization`` of the device's free
    memory (``torch.cuda.mem_get_info``) with KV blocks, clamped to [two
    blocks per sequence … full length for ``max_batch`` sequences].
    ``mem_bytes`` overrides the free-memory query (CPU callers pass it);
    ``bytes_per_token`` overrides the llama pools' K + V bytes per token
    (an arch adapter's own cache, e.g. DeepSeek's latent pool)."""
    if kv_quant:
        raise NotImplementedError("quantized KV pools are not ported yet")
    if bytes_per_token is None:
        dsize = torch.empty((), dtype=dtype).element_size()
        bytes_per_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * dsize
    bytes_per_block = bytes_per_token * block_size
    if mem_bytes is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError("calculate_cache_config needs mem_bytes off CUDA")
        free, _total = torch.cuda.mem_get_info(dev)
        if weight_bytes is not None:
            # weights not yet resident: subtract their projected size
            free -= max(weight_bytes - torch.cuda.memory_allocated(dev), 0)
    else:
        free = mem_bytes - (weight_bytes or 0)
    budget = int(free * utilization)
    # create() allocates num_blocks + 1 (the trash block)
    num_blocks = max(budget // bytes_per_block - 1, 1)
    min_blocks = max_batch * 2
    max_useful = -(-max_model_len // block_size) * max_batch
    return int(min(max(num_blocks, min_blocks), max_useful))
