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
for its DMA stripes). On CUDA tensors the kernel runs, one launch: a
split-KV flash decode on ``mma.sync`` (16 query heads as the MMA's 16 rows,
the f32 accumulator in registers, rows brought by bulk copies into a
ring), the splits of :func:`mla_plan` taking each sequence's tiles in turn;
each thread block cluster of splits merges its f32 partials in split order
through distributed shared memory, and the clusters' results are merged in
cluster order, slice by slice, by the last block of each slice. On CPU
tensors (or with ``plain=True``) the plain version below runs, with the
same math: an f32 softmax and an output of zeros for a row that sees no
position.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ._cuda import COUNTS, check, library, require, sm_count, split_counters, stream_ptr
from .paged_attention import LOG2E, _softmax_attend

MLA_TILE = 32  # positions per tile of the kernel; split s takes tiles s, s + splits, ...
MLA_HEADS = 16  # query heads per block: the MMA's 16 rows
MLA_COLUMNS = 512  # rank columns per block (DeepSeek's whole rank)
MLA_MAX_CLUSTER = 16  # splits of one thread block cluster (a non-portable cluster size)
MLA_BLOCKS_PER_SM = 1  # the grid's aim ...
MLA_MIN_TILES = 4  # ... where each split keeps at least this many of a full table's tiles


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


class MlaPlan(NamedTuple):
    splits: int  # blocks per (sequence, head tile); split s takes tiles s, s + splits, ...
    cluster: int  # splits per thread block cluster (divides splits, at most 16)


def clustered(splits: int) -> MlaPlan:
    """``splits`` (rounded up) in the fewest clusters of at most
    ``MLA_MAX_CLUSTER``, as even as they come."""
    n = -(-splits // MLA_MAX_CLUSTER)
    cluster = -(-splits // n)
    return MlaPlan(n * cluster, cluster)


@functools.lru_cache(maxsize=1024)
def mla_plan(b: int, head_tiles: int, w: int, block_size: int, sms: int = 132) -> MlaPlan:
    """The MLA decode kernel's splits of a table of ``w`` blocks of
    ``block_size`` positions, for ``b`` sequences of ``head_tiles`` blocks
    each (16 query heads, 512 rank columns a block) on a card of ``sms`` SMs.

    It reads static shapes only, never ``kv_lens``: the step can be captured
    in a CUDA graph, with no host sync. Split s of a sequence takes its
    32-position tiles s, s + splits, ..., so a short sequence spreads over
    as many splits as it has tiles whatever the plan. The grid (splits, b,
    head_tiles) gets about ``MLA_BLOCKS_PER_SM`` block per SM, but no split
    walks fewer than ``MLA_MIN_TILES`` tiles of a full table unless the
    whole table is shorter: each split costs its query load and its share of
    the merges. One block per SM, not two: on the H100 only 14 clusters of
    16 blocks fit the card at once, and at 8 x 4096 positions 32 splits a
    sequence (16 clusters, two waves) took 1.3x the time of 16
    (``probes/split_plans.py``, PERF.md)."""
    tiles = max(1, -(-w * block_size // MLA_TILE))
    want = max(1, MLA_BLOCKS_PER_SM * sms // max(1, b * head_tiles))
    return clustered(max(1, min(want, tiles // MLA_MIN_TILES)))


def mla_blocks(nh: int, rank: int) -> int:
    """Blocks per (sequence, split): head tiles of 16 times column groups
    of 512."""
    return -(-nh // MLA_HEADS) * -(-rank // MLA_COLUMNS)


def mla_counters(plan: MlaPlan, b: int, z: int) -> int:
    """The split counters an MLA decode launch of ``plan`` over ``b``
    sequences of ``z`` blocks each takes: one per (sequence, block, split
    of a cluster) when it has more than one cluster, else none."""
    return b * z * plan.cluster if plan.splits > plan.cluster else 0


def _mla_cuda(q, plane, row_new, slots, block_tables, kv_lens, block_size, rank, scale,
              plan: Optional[MlaPlan] = None):
    """The kernel's launch, at ``mla_plan``'s split unless a ``plan`` is
    given (``probes/split_plans.py`` times other splits)."""
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
    lib = library()
    out = torch.empty((b, nh, rank), dtype=torch.bfloat16, device=q.device)
    if b == 0:
        return out
    w = block_tables.shape[1]
    z = mla_blocks(nh, rank)
    plan = plan or mla_plan(b, z, w, block_size, sm_count(q.device))
    part = cnt = None
    # per (sequence, block, cluster): acc [16 x 512], (m, l) x 16; under a
    # graph capture the allocation comes from the graph's pool
    if plan.splits > plan.cluster:
        part = torch.empty(b * z * (plan.splits // plan.cluster) * MLA_HEADS * (MLA_COLUMNS + 2),
                           dtype=torch.float32, device=q.device)
        cnt = split_counters(q.device, mla_counters(plan, b, z))
    code = lib.mrt_mla_decode(
        q.data_ptr(), plane.data_ptr(), row_new.data_ptr(), slots.data_ptr(),
        block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
        b, nh, d, rank, s_total, w, block_size, plan.splits, plan.cluster,
        float(scale * LOG2E), stream_ptr(q),
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
