"""Paged attention with the KV write fused in (counterpart of
``mistralrs_tpu/ops/paged_attention.py``).

* :func:`paged_decode_attention_fused` — one query token per sequence: writes
  the step's K/V row to ``slots[b]`` (dropped when < 0), then attends over
  ``block_tables[b]`` up to ``kv_lens[b]``. **Decode kernel**
  (``csrc/paged_attention.cu``), replaces ``paged_decode_attention_fused``:
  split-KV flash decode on the tensor cores (``mma.sync`` with the K tile as
  the 16-row operand and the GQA group's queries as the 8-column one), the
  table's positions cut into the splits of :func:`decode_plan`, K/V tiles
  gathered into a ``cp.async`` ring, the splits' f32 partials merged in
  split order by the last block of each (sequence, KV head).
* :func:`paged_prefill_attention_fused` — T query tokens per sequence
  (chunked prefill): writes the chunk's valid rows, then attends causally
  over positions ``[kv_len − n_valid, kv_len)`` on top of the cached past.
  **Prefill kernel** (same file), replaces ``paged_prefill_attention_fused``:
  FlashAttention-2 on the tensor cores (``mma.sync``: QKᵀ and PV in bf16
  with f32 sums, P as two bf16 parts), K/V tiles gathered through the block
  table into a ``cp.async`` double buffer. It takes GQA groups 1 to 64: a
  query tile holds ``64 // group`` tokens, so a group that does not divide
  64 (Qwen2.5-7B's 7) leaves its last ``64 % group`` rows dead.

Pools are ``[L, n_kv, S, hd]`` (or one ``[n_kv, S, hd]`` plane) bf16 and are
updated in place; the functions return the attention output only. On CUDA
tensors the kernels run; on CPU tensors (or with ``plain=True``) the plain
PyTorch versions below run. Both use the same math as the JAX kernels: an
f32 softmax with masked logits at ``NEG_INF``, and an output of zeros for a
row that sees no position.

Quantized pools (int8 or fp8-e4m3 codes, ``kv/paged.py``) come with their
scale planes ``k_scale``/``v_scale`` (``[L, n_kv, S]`` or ``[n_kv, S]``
bf16) and run the kernels' quantized forms, the JAX kernels'
``quantized=True`` (``_decode_kernel`` :290-305, ``_prefill_kernel``
:671-706 and ``flash_head``): the step's rows are quantized as they are
written (``kv/paged.py::quantize_rows``: the plain versions quantize the
rows in the dtype they are given, the kernels take bf16 rows), and a
cached position's k scale multiplies its f32 score before the mask and the
running max, while its v scale multiplies ``p`` after ``p`` entered the
running sum ``l``, before the PV product. The prefill's own chunk attends
to its rows as ``bf16(code × s)`` with the unrounded f32 scale and no fold
(the JAX kernel's round trip in VMEM; the prefill kernel's quantized form
quantizes, writes and round-trips the chunk's rows once in a first launch,
into a scratch its attention launch reads).

Sliding windows, the attention logit softcap (Gemma-2, gpt-oss) and
attention sinks (gpt-oss), the JAX kernels' ``window``, ``softcap`` and
``sinks``, follow ``sdpa`` (JAX ``ops/attention.py:54-89``): a query at
position ``p`` sees a cached position ``s`` iff ``s <= p``, ``s < kv_len``
and ``p - s < window`` (0: no window; in decode ``p = kv_len - 1``), a
softcap ``c`` maps the scaled score ``x`` to ``tanh(x / c) * c`` before the
mask and the running max, and a head's sink is one more logit in its
softmax, uncapped, whose probability is dropped (its value is zero): a row
that sees no position still gives zeros. Every form, bf16 or quantized,
takes all three, at head_dim 64, 80, 96, 128 and 256 (:func:`form` names
the launch count of each: ``paged_decode``, ``paged_decode_hd64``,
``paged_decode_int8``, ``paged_decode_fp8_hd256``, ``paged_prefill_hd80``,
...; the kernels compute at the true head dim: pools ``[n_kv, S, 80]`` or
``[n_kv, S, 96]`` are not padded to 128 as the JAX package pads them for
its kernels); with 1-byte pools
the k scale multiplies the raw score before the softcap, the window's mask
and the running max, and no scale reaches a sink (JAX ``_decode_kernel``
:292-327). A windowed decode walks only the tiles its window reaches, and
its splits (:func:`decode_plan` with the window) cover only those.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..kv.paged import is_quantized, quantize_rows, write_kv
from ._cuda import (
    COUNTS,
    PAGED_HEAD_DIMS,
    check,
    library,
    require,
    sm_count,
    split_counters,
    stream_ptr,
)

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _plane(pool: torch.Tensor, layer: int) -> torch.Tensor:
    return pool[layer] if pool.dim() == 4 else pool


def _scale_plane(scale: Optional[torch.Tensor], layer: int) -> Optional[torch.Tensor]:
    return scale[layer] if scale is not None and scale.dim() == 3 else scale


def form(kernel: str, pool: torch.Tensor, hd: int = 128) -> str:
    """The launch-count name of ``kernel``'s form for ``pool`` and head_dim
    ``hd``: the kernel's own for bf16 pools at head_dim 128, ``_int8`` or
    ``_fp8`` after it for quantized pools, then ``_hd64``, ``_hd80``,
    ``_hd96`` or ``_hd256`` at another head dim the kernels take (its own
    template instances; the plain versions at any other head dim count
    under the head_dim-128 name)."""
    if is_quantized(pool):
        kernel += "_int8" if pool.dtype == torch.int8 else "_fp8"
    return f"{kernel}_hd{hd}" if hd in PAGED_HEAD_DIMS and hd != 128 else kernel


def _check_scales(pool, k_scale, v_scale, what: str) -> None:
    if is_quantized(pool) != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: 1-byte pools need k_scale and v_scale, and only they do")


def _gather_seq(plane: torch.Tensor, block_tables: torch.Tensor, block_size: int):
    """[n_kv, S, ...] plane (a pool's or a scale plane's) → per-sequence
    [B, n_kv, W * bs, ...] (f32)."""
    bt = block_tables.clamp_min(0).to(torch.long)
    slots = (bt[:, :, None] * block_size
             + torch.arange(block_size, device=bt.device)).reshape(bt.shape[0], -1)
    return plane[:, slots].transpose(0, 1).to(torch.float32)


def _softmax_attend(q, k, v, allowed, ks=None, vs=None, softcap: float = 0.0, sink=None):
    """q [B, n_kv, R, hd] (pre-scaled), k/v [B, n_kv, P, hd], allowed
    [B, 1|n_kv, R, P] bool → [B, n_kv, R, hd] f32, zeros where nothing is
    allowed (the kernels' flash form: acc / max(l, 1e-20)). With the per
    position scales ``ks``/``vs`` [B, n_kv, P] of codes ``k``/``v``, the k
    scale multiplies the scores before the mask and the max, the v scale
    multiplies ``p`` after the sum ``l`` took it (the JAX kernels' fold).
    A ``softcap`` maps the scores to ``tanh(s / softcap) * softcap`` before
    the mask. A ``sink`` [n_kv, R] (f32 logits, not capped) enters each
    row's max and sum as one more term with no value."""
    s = torch.einsum("bkrd,bkpd->bkrp", q, k)
    if ks is not None:
        s = s * ks[:, :, None, :]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    if sink is not None:
        m = torch.maximum(m, sink[None, :, :, None])
    p = torch.exp(s - m) * allowed
    l = p.sum(dim=-1, keepdim=True)
    if sink is not None:
        l = l + torch.exp(sink[None, :, :, None] - m)
    if vs is not None:
        p = p * vs[:, :, None, :]
    return torch.einsum("bkrp,bkpd->bkrd", p, v) / torch.clamp_min(l, 1e-20)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _sink_rows(sinks, n_kv: int, group: int, t: int = 1):
    """Per-head sinks [n_q] → the plain versions' [n_kv, t * group] f32 rows
    ordered (token, head in group), or None."""
    if sinks is None:
        return None
    return sinks.to(torch.float32).reshape(n_kv, 1, group).expand(n_kv, t, group).reshape(
        n_kv, t * group)


def paged_decode_attention_plain(
    q, k_pool, v_pool, k_new, v_new, slots, block_tables, kv_lens, layer=0,
    *, block_size: int, scale: float, k_scale=None, v_scale=None, window: int = 0,
    softcap: float = 0.0, sinks=None,
) -> torch.Tensor:
    """Plain version of the decode kernel and its quantized forms (same
    arguments, same result)."""
    _check_scales(k_pool, k_scale, v_scale, "paged decode attention")
    COUNTS[form("paged_decode", k_pool, q.shape[-1]) + "_plain"] += 1
    kp, vp = _plane(k_pool, layer), _plane(v_pool, layer)
    ks, vs = _scale_plane(k_scale, layer), _scale_plane(v_scale, layer)
    write_kv(kp, vp, k_new, v_new, slots, ks, vs)
    b, n_q, hd = q.shape
    n_kv = kp.shape[0]
    group = n_q // n_kv
    k = _gather_seq(kp, block_tables, block_size)
    v = _gather_seq(vp, block_tables, block_size)
    ksg = vsg = None
    if ks is not None:
        ksg = _gather_seq(ks, block_tables, block_size)
        vsg = _gather_seq(vs, block_tables, block_size)
    qg = q.to(torch.float32).reshape(b, n_kv, group, hd) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    lens = kv_lens.to(q.device).to(torch.long)[:, None]
    allowed = pos[None, :] < lens
    if window:
        allowed &= lens - 1 - pos[None, :] < window
    out = _softmax_attend(qg, k, v, allowed[:, None, None, :], ksg, vsg, softcap,
                          _sink_rows(sinks, n_kv, group))
    return out.reshape(b, n_q, hd).to(q.dtype)


DECODE_TILE = 64  # K/V positions per tile of the decode kernel; a split is a multiple
DECODE_BLOCKS_PER_SM = 2  # the decode grid's floor ...
DECODE_MIN_TILES = 4  # ... where each split keeps at least this many tiles
DECODE_MAX_GROUP = 16  # query heads per KV head: two 8-column tiles of the MMA
PREFILL_MAX_GROUP = 64  # query rows of a prefill tile: at least one token a tile


class DecodePlan(NamedTuple):
    positions: int  # positions per split, a multiple of DECODE_TILE
    splits: int  # splits per (sequence, KV head); positions * splits >= W * block_size


@functools.lru_cache(maxsize=1024)
def decode_plan(b: int, n_kv: int, group: int, w: int, block_size: int,
                sms: int = 132, window: int = 0) -> DecodePlan:
    """The decode kernel's split of a table of ``w`` blocks of ``block_size``
    positions, for ``b`` sequences of ``n_kv`` KV heads (GQA ``group``) on a
    card of ``sms`` SMs. With a sliding ``window`` the kernel walks only the
    positions from the tile that holds ``kv_len - window`` on, at most
    ``window`` positions and one tile: the splits cover those.

    It reads static shapes only, never ``kv_lens``: the step can be captured
    in a CUDA graph, with no host sync. The grid (splits, n_kv, b) gets at
    least ``DECODE_BLOCKS_PER_SM`` blocks per SM, but no split holds fewer
    than ``DECODE_MIN_TILES`` tiles unless the whole table does: shorter
    splits cost more in partials and in the in-order merge than their extra
    blocks win (PERF.md: at one 8192-position row, 43 splits of 3 tiles took
    1.4x the time of 32 splits of 4). The splits are as even as whole tiles
    allow, and a split past a sequence's length exits at once."""
    require(1 <= group <= DECODE_MAX_GROUP, f"GQA group {group} not in 1..{DECODE_MAX_GROUP}")
    tiles = max(1, -(-w * block_size // DECODE_TILE))
    if window > 0:
        tiles = min(tiles, -(-window // DECODE_TILE) + 1)
    want = max(1, -(-DECODE_BLOCKS_PER_SM * sms // max(1, b * n_kv)))
    # tiles a split, at the fewest splits that reach the floor
    per = min(tiles, max(DECODE_MIN_TILES, tiles // want))
    per = -(-tiles // -(-tiles // per))  # ... evened over the same number of splits
    return DecodePlan(DECODE_TILE * per, -(-tiles // per))


def decode_counters(plan: DecodePlan, b: int, n_kv: int) -> int:
    """The split counters a decode launch of ``plan`` takes: one per
    (sequence, KV head) when it splits, else none."""
    return b * n_kv if plan.splits > 1 else 0


def _check_pools(q, kp, vp, ks, vs, block_size: int) -> None:
    """The kernels' pool arguments: contiguous bf16 pools, or contiguous
    1-byte pools of one code type with contiguous bf16 scale planes
    ``[n_kv, S]`` and blocks of a multiple of 8 positions (a tile's scales
    are copied 8 positions at a time)."""
    n_kv, s_total, _ = kp.shape
    if ks is None:
        for name, t in (("k_pool", kp), ("v_pool", vp)):
            require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == q.device,
                    f"{name} must be contiguous bf16 on {q.device}")
        return
    for name, t in (("k_pool", kp), ("v_pool", vp)):
        require(t.dtype == kp.dtype and is_quantized(t) and t.is_contiguous()
                and t.device == q.device, f"{name} must be contiguous int8 or fp8 on {q.device}")
    for name, t in (("k_scale", ks), ("v_scale", vs)):
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == q.device
                and tuple(t.shape) == (n_kv, s_total),
                f"{name} must be contiguous bf16 [{n_kv}, {s_total}] on {q.device}")
    require(block_size % 8 == 0, f"quantized pools need blocks of a multiple of 8, got {block_size}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _exponent(scale: float, softcap: float) -> tuple[float, float]:
    """The kernels' score arithmetic: ``(e_mul, cap_in)``. Without a
    softcap the running max stays in raw score units and the exponent is
    ``2^((s - m) * scale * log2(e))``; with one, each raw score becomes
    ``softcap * tanh(s * cap_in)``, the true capped logit, and log2(e)
    multiplies after it (JAX ``_decode_kernel`` :244-246, :298-299)."""
    if softcap:
        return LOG2E, scale / softcap
    return scale * LOG2E, 0.0


def _check_head_dim(hd: int, what: str) -> None:
    require(hd in PAGED_HEAD_DIMS,
            f"{what} kernel needs head_dim 64, 80, 96, 128 or 256, got {hd}")


def _check_sinks(sinks, n_q: int, q: torch.Tensor) -> None:
    """The kernels read the sinks in place, one f32 per query head: a
    captured step keeps their address, so they are never converted here."""
    if sinks is not None:
        require(sinks.dtype == torch.float32 and sinks.is_contiguous()
                and tuple(sinks.shape) == (n_q,) and sinks.device == q.device,
                f"sinks must be contiguous f32 [{n_q}] on {q.device}")


def _decode_cuda(q, kp, vp, k_new, v_new, slots, block_tables, kv_lens, block_size, scale,
                 plan: Optional[DecodePlan] = None, ks=None, vs=None, window: int = 0,
                 softcap: float = 0.0, sinks=None):
    """The decode kernel's launch (its quantized form with the scale planes
    ``ks``/``vs``), at ``decode_plan``'s split unless a ``plan`` is given
    (``probes/split_plans.py`` times other splits)."""
    b, n_q, hd = q.shape
    n_kv, s_total, _ = kp.shape
    _check_head_dim(hd, "decode")
    require(n_q % n_kv == 0 and n_q // n_kv <= DECODE_MAX_GROUP,
            f"GQA group {n_q}/{n_kv} unsupported")
    _check_pools(q, kp, vp, ks, vs, block_size)
    _check_sinks(sinks, n_q, q)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == q.device,
                f"{name} must be contiguous bf16 on {q.device}")
    require(tuple(k_new.shape) == (b, n_kv, hd) and v_new.shape == k_new.shape,
            "k_new/v_new must be [B, n_kv, hd]")
    for name, t in (("slots", slots), ("block_tables", block_tables),
                    ("kv_lens", kv_lens)):
        require(t.dtype == torch.int32 and t.is_contiguous() and t.device == q.device,
                f"{name} must be contiguous int32 on {q.device}")
    require(slots.shape == (b,) and kv_lens.shape == (b,) and block_tables.shape[0] == b,
            "slots/kv_lens/block_tables batch mismatch")
    lib = library()
    w = block_tables.shape[1]
    plan = plan or decode_plan(b, n_kv, n_q // n_kv, w, block_size, sm_count(q.device),
                               window)
    out = torch.empty_like(q)
    part = cnt = None
    if plan.splits > 1:  # per (sequence, query head, split): acc[hd], then (m, l)
        part = torch.empty(b * n_q * plan.splits * (hd + 2), dtype=torch.float32,
                           device=q.device)
        cnt = split_counters(q.device, decode_counters(plan, b, n_kv))
    e_mul, cap_in = _exponent(scale, softcap)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            slots.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            _ptr(part), _ptr(cnt), _ptr(sinks), b, n_q, n_kv, hd, int(window), float(softcap),
            float(cap_in), s_total, w, block_size, plan.positions, plan.splits, float(e_mul))
    name = form("paged_decode", kp, hd)
    if ks is None:
        code = lib.mrt_paged_decode(*args, stream_ptr(q))
    else:
        code = lib.mrt_paged_decode_q(*args, ks.data_ptr(), vs.data_ptr(),
                                      int(kp.dtype != torch.int8), stream_ptr(q))
    check(code, name)
    COUNTS[name] += 1
    return out


def paged_decode_attention_fused(
    q: torch.Tensor,  # [B, n_q, hd]
    k_pool: torch.Tensor,  # [L, n_kv, S, hd] or [n_kv, S, hd], updated in place
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, n_kv, hd] this step's KV rows
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B] int32 write slots (< 0 → dropped)
    block_tables: torch.Tensor,  # [B, W] int32
    kv_lens: torch.Tensor,  # [B] int32 (length AFTER this step's write)
    layer: int = 0,
    *,
    block_size: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,
    plain: bool = False,
    k_scale: Optional[torch.Tensor] = None,  # [L, n_kv, S] or [n_kv, S] bf16 (1-byte pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused reshape_and_cache + paged decode attention → out [B, n_q, hd].
    ``window`` (0: none) and ``softcap`` (0: none) are Python numbers: a
    captured step keeps them as they were at capture. ``sinks``: f32
    ``[n_q]`` logits (or None), read in place by the kernel."""
    _check_scales(k_pool, k_scale, v_scale, "paged decode attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if plain or q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, k_new, v_new, slots, block_tables, kv_lens, layer,
            block_size=block_size, scale=scale, k_scale=k_scale, v_scale=v_scale,
            window=window, softcap=softcap, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention: unsupported device {q.device}")
    return _decode_cuda(q, _plane(k_pool, layer), _plane(v_pool, layer), k_new, v_new,
                        slots, block_tables, kv_lens, block_size, scale,
                        ks=_scale_plane(k_scale, layer), vs=_scale_plane(v_scale, layer),
                        window=window, softcap=softcap, sinks=sinks)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def chunk_round_trip(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """How the quantized prefill reads its chunk's own rows: ``bf16(code ×
    s)`` with the unrounded f32 scale, as the JAX prefill kernel does in
    VMEM (the JAX package's XLA path reads them back from the pool as
    ``code × bf16(s)`` instead)."""
    return (codes.to(torch.float32) * s[..., None]).to(torch.bfloat16)


def paged_prefill_attention_plain(
    q, k_pool, v_pool, k_new, v_new, slots, block_tables, kv_lens, n_valid, layer=0,
    *, block_size: int, scale: float, k_scale=None, v_scale=None, window: int = 0,
    softcap: float = 0.0, sinks=None,
) -> torch.Tensor:
    """Plain version of the prefill kernel and its quantized forms. Rows
    past ``n_valid`` write nothing and return zeros (the kernel's output
    there is never read)."""
    _check_scales(k_pool, k_scale, v_scale, "paged prefill attention")
    COUNTS[form("paged_prefill", k_pool, q.shape[-1]) + "_plain"] += 1
    kp, vp = _plane(k_pool, layer), _plane(v_pool, layer)
    ks, vs = _scale_plane(k_scale, layer), _scale_plane(v_scale, layer)
    b, t, n_q, hd = q.shape
    n_kv = kp.shape[0]
    group = n_q // n_kv
    dev = q.device
    kv_lens = kv_lens.to(dev).to(torch.long)
    n_valid = n_valid.to(dev).to(torch.long)
    tok = torch.arange(t, device=dev)
    valid = tok[None, :] < n_valid[:, None]  # [B, T]
    # past K/V come from the pool as it was; the chunk's own from k_new/v_new
    k = _gather_seq(kp, block_tables, block_size)  # [B, n_kv, P, hd]
    v = _gather_seq(vp, block_tables, block_size)
    quant = ks is not None
    ksg = vsg = None
    if quant:  # the past's scales [B, n_kv, P]
        ksg = _gather_seq(ks, block_tables, block_size)
        vsg = _gather_seq(vs, block_tables, block_size)
    ctx = kv_lens - n_valid
    n_pos = max(k.shape[2], int((ctx + t).max()) if b else 0)
    if n_pos > k.shape[2]:
        pad = n_pos - k.shape[2]
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if quant:
            ksg = torch.nn.functional.pad(ksg, (0, pad))
            vsg = torch.nn.functional.pad(vsg, (0, pad))
    for i in range(b):
        nv, c = int(n_valid[i]), int(ctx[i])
        for x, new, sc in ((k, k_new, ksg), (v, v_new, vsg)):
            rows = new[i, :nv].transpose(0, 1)  # [n_kv, nv, hd]
            if quant:  # round-tripped, no fold
                rows = chunk_round_trip(*quantize_rows(rows, kp.dtype))
                sc[i, :, c:c + nv] = 1.0
            x[i, :, c:c + nv] = rows.to(torch.float32)
    write_kv(kp, vp, k_new.reshape(b * t, n_kv, hd), v_new.reshape(b * t, n_kv, hd),
             torch.where(valid, slots.to(dev), torch.full_like(slots.to(dev), -1)).reshape(-1),
             ks, vs)
    # rows ordered (token, head-in-group) like the kernel's query tile
    qg = (q.to(torch.float32).reshape(b, t, n_kv, group, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, n_kv, t * group, hd) * scale)
    pos = torch.arange(k.shape[2], device=dev)
    lim = ctx[:, None] + tok[None, :]  # [B, T] last visible position
    allowed = (pos[None, None, :] <= lim[:, :, None]) & valid[:, :, None]
    if window:
        allowed &= lim[:, :, None] - pos[None, None, :] < window
    allowed = allowed.repeat_interleave(group, dim=1)[:, None]  # [B, 1, T*G, P]
    out = _softmax_attend(qg, k, v, allowed, ksg, vsg, softcap,
                          _sink_rows(sinks, n_kv, group, t))
    out = out.reshape(b, n_kv, t, group, hd).permute(0, 2, 1, 3, 4).reshape(b, t, n_q, hd)
    return out.to(q.dtype)


def _prefill_cuda(q, kp, vp, k_new, v_new, slots, block_tables, kv_lens, n_valid,
                  block_size, scale, ks=None, vs=None, window: int = 0, softcap: float = 0.0,
                  sinks=None):
    b, t, n_q, hd = q.shape
    n_kv, s_total, _ = kp.shape
    _check_head_dim(hd, "prefill")
    require(n_q % n_kv == 0 and 1 <= n_q // n_kv <= PREFILL_MAX_GROUP,
            f"GQA group {n_q}/{n_kv} not in 1..{PREFILL_MAX_GROUP}")
    _check_pools(q, kp, vp, ks, vs, block_size)
    _check_sinks(sinks, n_q, q)
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        require(x.dtype == torch.bfloat16 and x.is_contiguous() and x.device == q.device,
                f"{name} must be contiguous bf16 on {q.device}")
    require(tuple(k_new.shape) == (b, t, n_kv, hd) and v_new.shape == k_new.shape,
            "k_new/v_new must be [B, T, n_kv, hd]")
    for name, x in (("slots", slots), ("block_tables", block_tables),
                    ("kv_lens", kv_lens), ("n_valid", n_valid)):
        require(x.dtype == torch.int32 and x.is_contiguous() and x.device == q.device,
                f"{name} must be contiguous int32 on {q.device}")
    require(tuple(slots.shape) == (b, t) and kv_lens.shape == (b,) and n_valid.shape == (b,)
            and block_tables.shape[0] == b, "slots/kv_lens/n_valid/block_tables mismatch")
    out = torch.empty_like(q)
    lib = library()
    e_mul, cap_in = _exponent(scale, softcap)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            slots.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(), n_valid.data_ptr(),
            out.data_ptr(), _ptr(sinks), b, t, n_q, n_kv, hd, int(window), float(softcap),
            float(cap_in), s_total, block_tables.shape[1], block_size, float(e_mul))
    name = form("paged_prefill", kp, hd)
    if ks is None:
        code = lib.mrt_paged_prefill(*args, stream_ptr(q))
    else:
        # the chunk's rows' round trips, which the attention launch reads
        k_rt, v_rt = torch.empty_like(k_new), torch.empty_like(v_new)
        code = lib.mrt_paged_prefill_q(*args, ks.data_ptr(), vs.data_ptr(),
                                       int(kp.dtype != torch.int8), k_rt.data_ptr(),
                                       v_rt.data_ptr(), stream_ptr(q))
    check(code, name)
    COUNTS[name] += 1
    return out


def paged_prefill_attention_fused(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_pool: torch.Tensor,  # [L, n_kv, S, hd] or [n_kv, S, hd], updated in place
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, n_kv, hd] this chunk's KV rows
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, T] int32 write slots (< 0 → dropped)
    block_tables: torch.Tensor,  # [B, W] int32
    kv_lens: torch.Tensor,  # [B] int32 (length AFTER this chunk's writes)
    n_valid: torch.Tensor,  # [B] int32 valid tokens of this chunk (≤ T)
    layer: int = 0,
    *,
    block_size: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,
    plain: bool = False,
    k_scale: Optional[torch.Tensor] = None,  # [L, n_kv, S] or [n_kv, S] bf16 (1-byte pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused reshape_and_cache + causal paged attention for T > 1 → out
    [B, T, n_q, hd]. Each row's valid tokens [0, n_valid) are the
    consecutive positions [kv_len − n_valid, kv_len) (the engine's prefill
    invariant, as in the JAX kernel). ``sinks`` as for the decode."""
    _check_scales(k_pool, k_scale, v_scale, "paged prefill attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if plain or q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pool, v_pool, k_new, v_new, slots, block_tables, kv_lens, n_valid,
            layer, block_size=block_size, scale=scale, k_scale=k_scale, v_scale=v_scale,
            window=window, softcap=softcap, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged prefill attention: unsupported device {q.device}")
    return _prefill_cuda(q, _plane(k_pool, layer), _plane(v_pool, layer), k_new, v_new,
                         slots, block_tables, kv_lens, n_valid, block_size, scale,
                         ks=_scale_plane(k_scale, layer), vs=_scale_plane(v_scale, layer),
                         window=window, softcap=softcap, sinks=sinks)
