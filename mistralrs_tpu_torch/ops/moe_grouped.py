"""Grouped (ragged) MoE expert compute (counterpart of
``mistralrs_tpu/ops/moe_grouped.py``).

(token, choice) pairs are sorted by expert and each expert's group is padded
to a whole number of ``tm``-row tiles, so one grouped matmul per projection
streams each needed expert's weights once per row tile: ``tile_idx[t]`` names
the expert of tile ``t``. Quantized leaves go to
:func:`~mistralrs_tpu_torch.ops.quant_matmul.quant_matmul_grouped` (the W4
and W8 grouped kernels), a dense bf16 leaf to :func:`dense_matmul_grouped`
(the **dense grouped kernel**, replacing ``_dense_matmul_g``:
``csrc/dense_grouped.cu``). Its two bodies, by row tile
(:func:`dense_grouped_plan`): 16-row tiles take a decode body (``mma.sync``
with the weight as the 16-row operand, a 4-stage ``cp.async`` ring, blocks
of 64 columns over all of K); 64-row tiles take a ``wgmma`` prefill body
(weight and x both K-major in shared memory, pairs of one expert's tiles a
block, 256 columns).

``tm`` is the port's own M-tile, which the kernels must match: 16 rows when
``n * k <= 256`` (decode: 16 pairs over ~7 of 8 experts would pad to 512 rows
with a 64-row tile) and 64 otherwise. Everything here stays on the device
with no host round trip (``build_groups`` returns the used-tile count as a
device scalar), so the engine's decode step is captured in a CUDA graph
(``engine/decode_step.py``), and the combine adds each token's
contributions in a fixed order, so a replay gives the eager step's bits.
Expert parallelism is not ported and raises.

:func:`gpt_oss_grouped_mlp` is gpt-oss's expert MLP (JAX
``_gpt_oss_experts``, ``models/llama.py:496-529``) on the same route: two
launches of the dense grouped kernel over the bf16 banks, each row's
expert bias gathered by its tile's expert, and the clamped SwiGLU between
them. The JAX package runs every expert on every token there, outside any
Pallas kernel; at gpt-oss-20b's width that would read all 32 experts'
weights (1.6 GB a layer) at every step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..quant.qtensor import QTensor
from ._cuda import COUNTS, check, library, require, stream_ptr
from .quant_matmul import (
    _bf16_rows,
    check_groups,
    quant_matmul_grouped,
    used_tile_rows,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_groups(
    topi: torch.Tensor,  # [n, k] expert choice per token
    topw: torch.Tensor,  # [n, k] combine weight
    num_banks: int,
    tm: int,
):
    """Sort (token, choice) pairs by expert and pad each group to ``tm``.

    Returns ``(st, dest, sw, tile_idx, n_used_tiles, mp)``: the source token
    of each sorted pair, its padded destination row, its combine weight, the
    expert of every row tile (int32, trailing empty tiles clipped to the last
    expert as the JAX package does), the number of tiles that non-empty
    groups fill (an int32 device scalar), and the static padded row count
    (the worst case: ``n*k`` rows plus ``tm - 1`` padding per non-empty
    group)."""
    return _groups(topi, topw, num_banks, tm)[:6]


def _groups(topi, topw, num_banks: int, tm: int):
    """:func:`build_groups`'s results, then ``order``: the flat (token,
    choice) index of each sorted pair."""
    n, k = topi.shape
    nk = n * k
    dev = topi.device
    flat_e = topi.reshape(nk).to(torch.int64)
    flat_w = topw.reshape(nk)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sw = flat_w[order]
    st = torch.arange(nk, device=dev)[order] // k
    starts = torch.searchsorted(se, torch.arange(num_banks, device=dev))
    sizes = torch.diff(starts, append=torch.full((1,), nk, device=dev))
    padded = (sizes + tm - 1) // tm * tm
    pad_off = torch.cumsum(padded, 0) - padded  # exclusive prefix
    rank = torch.arange(nk, device=dev) - starts[se]
    dest = pad_off[se] + rank
    mp = _round_up(nk + min(num_banks, nk) * (tm - 1), tm)
    tile_start = torch.arange(mp // tm, device=dev) * tm
    tile_idx = (torch.searchsorted(pad_off, tile_start, right=True) - 1).clamp(0, num_banks - 1)
    n_used = (padded.sum() // tm).to(torch.int32).reshape(1)
    return st, dest, sw, tile_idx.to(torch.int32), n_used, mp, order


# ---------------------------------------------------------------------------
# the dense grouped kernel
# ---------------------------------------------------------------------------


def dense_matmul_grouped_plain(
    x2: torch.Tensor, w: torch.Tensor, tile_idx: torch.Tensor, *, tm: int,
    n_used_tiles: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: each used tile times its expert's weight cast
    to ``x``'s dtype, f32 products, result in ``x``'s dtype; tiles at or past
    ``n_used_tiles`` are zero."""
    COUNTS["dense_matmul_g_plain"] += 1
    out = torch.zeros((x2.shape[0], w.shape[1]), dtype=torch.float32, device=x2.device)
    xf = x2.to(torch.float32)
    for e, rows in used_tile_rows(tile_idx, n_used_tiles, tm).items():
        out[rows] = xf[rows] @ w[e].to(x2.dtype).to(torch.float32).T
    return out.to(x2.dtype)


class DensePlan(NamedTuple):
    body: str  # "decode" (16-row tiles, mma.sync), "prefill" (64-row tiles, wgmma)
    columns: int  # output columns per block


DENSE_PLANS = {16: DensePlan("decode", 64), 64: DensePlan("prefill", 256)}


def dense_grouped_plan(tm: int) -> DensePlan:
    """The dense grouped kernel's body and column-block width for ``tm``-row
    tiles: the row tile alone decides (a static shape; the used tiles stay a
    device scalar, never read here). The decode body walks all of K in each
    block: 128-column blocks and K split across blocks were never faster on
    the served banks (PERF.md)."""
    require(tm in DENSE_PLANS, f"row tile {tm} not in {tuple(DENSE_PLANS)}")
    return DENSE_PLANS[tm]


def _dense_matmul_grouped_cuda(
    x2: torch.Tensor, w: torch.Tensor, tile_idx: torch.Tensor,
    n_used_tiles: torch.Tensor, tm: int,
) -> torch.Tensor:
    mp, k = x2.shape
    _, n, _ = w.shape
    require(x2.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
            f"the CUDA kernel takes bf16 rows and bank, not {x2.dtype}, {w.dtype}")
    require(w.device == x2.device, "weight and input on different devices")
    require(w.is_contiguous() and w.data_ptr() % 16 == 0, "bank must be contiguous")
    require(k % 64 == 0 and n % 16 == 0,
            f"kernel needs K % 64 == 0 and N % 16 == 0, got K={k}, N={n}")
    n_used = check_groups(x2, tile_idx, n_used_tiles, tm)
    x2 = _bf16_rows(x2)
    out = torch.empty((mp, n), dtype=torch.bfloat16, device=x2.device)
    if mp == 0:
        return out
    code = library().mrt_dense_matmul_grouped(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), tile_idx.data_ptr(), n_used.data_ptr(),
        mp, n, k, tm, w[0].numel(), stream_ptr(x2),
    )
    check(code, "dense_matmul_g")
    COUNTS["dense_matmul_g"] += 1
    return out


def dense_matmul_grouped(
    x: torch.Tensor,  # [T*tm, K]
    w: torch.Tensor,  # [E, N, K]
    tile_idx: torch.Tensor,  # [T] int32
    *,
    tm: int,
    n_used_tiles: torch.Tensor,
    plain: bool = False,
) -> torch.Tensor:
    """Grouped ``x @ w[tile_idx[t]].T`` over a dense bank, in ``x``'s dtype.
    A CUDA tensor launches the dense grouped kernel (or raises); a CPU
    tensor, or ``plain=True``, runs the plain version."""
    if w.dim() != 3 or x.dim() != 2 or x.shape[1] != w.shape[2] or x.shape[0] % tm:
        raise ValueError(f"x {tuple(x.shape)} and bank {tuple(w.shape)} do not fit "
                         f"[T*{tm}, K] @ [E, N, K]")
    if plain or x.device.type == "cpu":
        return dense_matmul_grouped_plain(x, w, tile_idx, tm=tm, n_used_tiles=n_used_tiles)
    if x.device.type == "cuda":
        return _dense_matmul_grouped_cuda(x, w, tile_idx, n_used_tiles, tm)
    raise ValueError(f"dense_matmul_grouped: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# the expert MLP
# ---------------------------------------------------------------------------


def grouped_tile(n_pairs: int) -> int:
    """The port's M-tile for ``n_pairs`` (token, choice) pairs."""
    return 16 if n_pairs <= 256 else 64


def moe_grouped_mlp(
    x: torch.Tensor,  # [n, H]
    experts: dict,  # gate/up/down or gateup/down: QTensor [E, ...] or dense [E, out, in]
    topw: torch.Tensor,  # [n, k]
    topi: torch.Tensor,  # [n, k]
    act: Callable[[torch.Tensor], torch.Tensor],
    *,
    expert_offset=None,
    num_local: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """Gated expert MLP (SwiGLU family) over a ragged token→expert routing.
    ``gateup`` is gate and up fused along the output axis (one launch).
    Quantized leaves dequantize to ``compute_dtype`` (the JAX function's
    ``dequant_dtype``)."""
    if expert_offset is not None or num_local is not None:
        raise NotImplementedError("expert parallelism is not ported yet")
    n, h = x.shape
    k = topi.shape[-1]
    down = experts["down"]
    nb = down.num_banks if isinstance(down, QTensor) else down.shape[0]
    tm = grouped_tile(n * k)
    st, dest, _, tile_idx, n_used, mp, order = _groups(topi, topw, nb, tm)
    xs = torch.zeros((mp, h), dtype=x.dtype, device=x.device)
    xs[dest] = x[st]

    def gmm(rows, w):
        if isinstance(w, QTensor):
            return quant_matmul_grouped(rows, w, tile_idx, tm=tm, n_used_tiles=n_used,
                                        out_dtype=rows.dtype, compute_dtype=compute_dtype,
                                        plain=plain)
        return dense_matmul_grouped(rows, w, tile_idx, tm=tm, n_used_tiles=n_used,
                                    plain=plain)

    if "gateup" in experts:
        gu = gmm(xs, experts["gateup"])
        half = gu.shape[-1] // 2
        hidden = act(gu[:, :half]) * gu[:, half:]
    else:
        hidden = act(gmm(xs, experts["gate"])) * gmm(xs, experts["up"])
    y = gmm(hidden.to(x.dtype), down)
    return _combine(y, dest, order, topw)


def _combine(y, dest, order, topw):
    """Each token's k contributions (rows of ``y``, weighted by ``topw``)
    summed in f32 and rounded once, in a fixed order on every device
    (index_add_ on CUDA adds by atomics in any order, so two runs of one
    step could differ in their last bits)."""
    n, k = topw.shape
    rows = torch.empty_like(dest)
    rows[order] = dest  # y's row of each (token, choice) pair
    contrib = y[rows].reshape(n, k, y.shape[-1]) * topw[..., None].to(y.dtype)
    return contrib.to(torch.float32).sum(dim=1).to(y.dtype)


SWIGLU_LIMIT = 7.0  # gpt-oss's clamp (JAX _gpt_oss_experts: limit)
SWIGLU_ALPHA = 1.702


def gpt_oss_grouped_mlp(
    x: torch.Tensor,  # [n, H]
    experts: dict,  # gateup [E, 2I, H], gateup_bias [E, 2I], down [E, H, I], down_bias [E, H]
    topw: torch.Tensor,  # [n, k]
    topi: torch.Tensor,  # [n, k]
    *,
    plain: bool = False,
) -> torch.Tensor:
    """gpt-oss's expert MLP: ``gate, up = x W_gu[e] + b_gu[e]`` (``gateup``
    holds the gate rows, then the up rows: the checkpoint's interleave
    undone at load), ``gate = min(gate, 7)``, ``up = clip(up, -7, 7)``,
    ``h = (up + 1) * gate * sigmoid(1.702 gate)``, ``y = h W_d[e] +
    b_d[e]``, each in ``x``'s dtype as the JAX package computes it, and the
    k choices combined as :func:`moe_grouped_mlp` does."""
    n, h = x.shape
    k = topi.shape[-1]
    gateup, down = experts["gateup"], experts["down"]
    tm = grouped_tile(n * k)
    st, dest, _, tile_idx, n_used, mp, order = _groups(topi, topw, down.shape[0], tm)
    xs = torch.zeros((mp, h), dtype=x.dtype, device=x.device)
    xs[dest] = x[st]
    row_e = tile_idx.long()[:, None].expand(-1, tm).reshape(-1)  # each row's expert

    def gmm(rows, w, bias):
        out = dense_matmul_grouped(rows, w, tile_idx, tm=tm, n_used_tiles=n_used, plain=plain)
        return out + bias[row_e].to(out.dtype)

    gu = gmm(xs, gateup, experts["gateup_bias"])
    half = gu.shape[-1] // 2
    gate = gu[:, :half].clamp(max=SWIGLU_LIMIT)
    up = gu[:, half:].clamp(-SWIGLU_LIMIT, SWIGLU_LIMIT)
    hidden = (up + 1.0) * (gate * torch.sigmoid(gate * SWIGLU_ALPHA))
    y = gmm(hidden, down, experts["down_bias"])
    return _combine(y, dest, order, topw)
