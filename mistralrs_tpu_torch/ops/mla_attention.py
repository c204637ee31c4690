"""MLA paged decode with the latent-row write fused in (counterpart of
``mistralrs_tpu/ops/mla_attention.py``).

Absorbed multi-head latent attention is MQA over ONE combined row per token,
``[compressed latent ‖ roped k_pe]`` (``D = rank + rope`` wide), shared by
every query head: scores = ``q · row``, values = ``row[:rank]``.

:func:`mla_decode` writes this step's row of each sequence into the pool's
layer plane (a slot < 0 goes to the trash row ``S_total - 1``), then attends
over ``block_tables[b]`` up to ``kv_lens[b]``. **MLA decode kernel**
(``csrc/mla_attention.cu``), replaces ``mla_decode_fused``. Pools are
``[L, S_total, D]`` (or one ``[S_total, D]`` plane) and are updated in
place; rows are exactly ``D`` wide (the JAX package pads them to 128 lanes
for its DMA stripes). On CUDA tensors the kernel runs; on CPU tensors (or
with ``plain=True``) the plain version below, with the same math: an f32
softmax and an output of zeros for a row that sees no position.
"""

from __future__ import annotations

import torch

from ._cuda import COUNTS, check, library, require, stream_ptr
from .paged_attention import LOG2E, _softmax_attend

SPLIT_TILE = 64  # positions per tile of the kernel; a split is a multiple
TARGET_BLOCKS = 264  # ~2 blocks per SM of the H100 (132 SMs)


def _plane(pool: torch.Tensor, layer: int) -> torch.Tensor:
    return pool[layer] if pool.dim() == 3 else pool


def mla_decode_plain(
    q, pool, row_new, slots, block_tables, kv_lens, layer=0,
    *, block_size: int, rank: int, scale: float,
) -> torch.Tensor:
    """Plain version of the MLA decode kernel (same arguments, same result)."""
    COUNTS["mla_decode_plain"] += 1
    plane = _plane(pool, layer)
    b = q.shape[0]
    dev = plane.device
    slots = slots.to(device=dev, dtype=torch.long)
    plane[torch.where(slots < 0, plane.shape[0] - 1, slots)] = row_new.to(plane.dtype)
    bt = block_tables.to(dev).clamp_min(0).to(torch.long)
    gather = (bt[:, :, None] * block_size
              + torch.arange(block_size, device=dev)).reshape(b, -1)
    keys = plane[gather].to(torch.float32)[:, None]  # [B, 1, P, D]
    pos = torch.arange(keys.shape[2], device=dev)
    allowed = (pos[None, :] < kv_lens.to(dev)[:, None])[:, None, None, :]
    out = _softmax_attend(q.to(torch.float32)[:, None] * scale, keys, keys[..., :rank], allowed)
    return out[:, 0].to(q.dtype)


def _splits(b: int, nh: int, max_positions: int) -> tuple[int, int]:
    """``(n_split, span)``: the kernel's KV splits per sequence and the
    positions each covers (a multiple of 64), enough splits for ~2 blocks
    per SM over all sequences and head tiles."""
    n_tiles = max(1, -(-max_positions // SPLIT_TILE))
    want = max(1, -(-TARGET_BLOCKS // (b * -(-nh // 16))))
    span = SPLIT_TILE * -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles * SPLIT_TILE // span), span


def _mla_cuda(q, plane, row_new, slots, block_tables, kv_lens, block_size, rank, scale):
    b, nh, d = q.shape
    s_total = plane.shape[0]
    require(d % 8 == 0 and rank % 16 == 0 and 16 <= rank <= d,
            f"MLA decode kernel needs D % 8 == 0 and rank % 16 == 0 (rank <= D), "
            f"got D={d}, rank={rank}")
    require(tuple(plane.shape) == (s_total, d) and tuple(row_new.shape) == (b, d),
            "pool plane must be [S, D] and row_new [B, D]")
    for name, t in (("q", q), ("pool", plane), ("row_new", row_new)):
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == q.device
                and t.data_ptr() % 16 == 0, f"{name} must be contiguous bf16 on {q.device}")
    for name, t in (("slots", slots), ("block_tables", block_tables), ("kv_lens", kv_lens)):
        require(t.dtype == torch.int32 and t.is_contiguous() and t.device == q.device,
                f"{name} must be contiguous int32 on {q.device}")
    require(slots.shape == (b,) and kv_lens.shape == (b,) and block_tables.shape[0] == b,
            "slots/kv_lens/block_tables batch mismatch")
    out = torch.empty((b, nh, rank), dtype=torch.bfloat16, device=q.device)
    if b == 0:
        return out
    n_split, span = _splits(b, nh, block_tables.shape[1] * block_size)
    o_part = torch.empty((b, n_split, nh, rank), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((b, n_split, nh, 2), dtype=torch.float32, device=q.device)
    code = library().mrt_mla_decode(
        q.data_ptr(), plane.data_ptr(), row_new.data_ptr(), slots.data_ptr(),
        block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), b, nh, d, rank, s_total, block_tables.shape[1], block_size,
        span, n_split, float(scale * LOG2E), stream_ptr(q),
    )
    check(code, "mla_decode")
    COUNTS["mla_decode"] += 1
    return out


def mla_decode(
    q: torch.Tensor,  # [B, nh, D] combined query [q_lat ‖ q_pe]
    pool: torch.Tensor,  # [L, S_total, D] or [S_total, D], updated in place
    row_new: torch.Tensor,  # [B, D] this step's combined rows
    slots: torch.Tensor,  # [B] int32 write slots (< 0 → the trash row)
    block_tables: torch.Tensor,  # [B, W] int32
    kv_lens: torch.Tensor,  # [B] int32 (length AFTER this step's write)
    layer: int = 0,
    *,
    rank: int,
    block_size: int,
    scale: float,
    plain: bool = False,
) -> torch.Tensor:
    """Fused latent-row write + MLA flash decode → out ``[B, nh, rank]``
    (``scale``: DeepSeek's ``qk_head_dim ** -0.5``, not ``D ** -0.5``)."""
    if plain or q.device.type == "cpu":
        return mla_decode_plain(q, pool, row_new, slots, block_tables, kv_lens, layer,
                                block_size=block_size, rank=rank, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla decode: unsupported device {q.device}")
    return _mla_cuda(q, _plane(pool, layer), row_new, slots, block_tables, kv_lens,
                     block_size, rank, scale)
