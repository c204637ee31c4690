"""Fused dequant + matmul (counterpart of ``mistralrs_tpu/ops/quant_matmul.py``).

``quant_matmul(x, qt)`` computes ``x @ w.T`` for a planar-quantized weight
``w = [N, K]``. On a CUDA tensor it launches a hand-written kernel: the **W4
kernel** (``csrc/w4_matmul.cu``) for split-half packed 4-bit codes (Q4_K;
GPTQ and AWQ 4-bit; replaces ``_w4_matmul``/``_w4_matmul_l``), or the **W8
kernel** (``csrc/w8_matmul.cu``) for one byte per code (Q8_0, Q6_K,
unsigned with bias, the widened form, GPTQ 8-bit and per-column GPTQ;
replaces ``_w8_matmul``/``_w8_matmul_l``). Group sizes (:func:`_check_planes`),
for one matrix and a bank alike: W4 16, 32, 64 and 128 dividing K/2; W8 16
and 32, or 64 and any multiple of 128 dividing K (``group_size: -1``'s
per-column scales are g = K). The groups over the k-quants' 32 are the
kernels' wide-group forms, counted apart as ``w4_matmul_wide`` and
``w8_matmul_wide`` (``..._wide_g`` over a bank: GPTQ and AWQ expert banks);
W4 at group 16 (Q2_K's 2-bit codes in nibbles) counts as ``w4_matmul_g16``
(``w4_matmul_g16_g`` over a bank).
An FP8 weight (``quant/fp8.py``'s :class:`Fp8Tensor`: one e4m3 byte per
weight, no bias plane) takes the W8 kernel's **e4m3 form** (replaces JAX
``quant/fp8.py::fp8_matmul``, which XLA computes): both bodies, at groups of
64 or a multiple of 128 dividing K (a block scale of ``bk`` rows of K, or
one per-tensor group of K), its expanded scale plane as the kernel's,
counted as ``w8_matmul_e4m3``; other shapes raise (:func:`_check_fp8`).
On a CPU
tensor it runs :func:`quant_matmul_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX package and the card's
smoke run holds the kernels against.

``quant_matmul_grouped(x, bank, tile_idx, ...)`` is the grouped (MoE) form
over a bank ``[E, N, K]``: row-tile ``t`` of ``x`` multiplies expert
``tile_idx[t]``. On a CUDA tensor it launches the **W4 grouped kernel**
(replaces ``_w4_matmul_g``) or the **W8 grouped kernel** (replaces
``_w8_matmul_g``): each kernel's own bodies with a bank offset. On a CPU
tensor it runs :func:`quant_matmul_grouped_plain`.

Each kernel has two bodies, chosen by its plan (:func:`w4_plan`,
:func:`w8_plan`). Row tiles of at most 16 rows (dense M <= 16, grouped
``tm = 16``) take the decode body of ``csrc/mm_decode.cuh``, which W4 and
W8 share (``mma.sync`` with the weight as the 16-row operand, K of one
matrix split across blocks as :func:`decode_splits` says). Larger tiles
take a ``wgmma`` prefill body: W4's dequantizes the weight into shared
memory as the B operand (``csrc/w4_matmul.cu``); W8's makes it the A operand
in registers (``csrc/w8_prefill.cu``), in the row tile and K splits of
:func:`prefill_tile_splits`. The sources say how each is built.

The plain versions compute ``w = compute_dtype(scale * q + bias)`` (f32
multiply and add, then one rounding) and accumulate ``x · w`` in f32, the
k-quant "min" bias folded into the weight as the JAX package's XLA path does.
The W8 prefill body dequantizes exactly so, the W4 prefill body within an
f32 ulp before the rounding; the decode body takes scale and bias out of the
inner loop as group sums of ``x`` (the TPU kernel's ``f32dot_bias``
arithmetic) and never rounds the weight. All agree with the plain versions
within 1e-2 of the largest |output|.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..quant.fp8 import Fp8Tensor
from ..quant.qtensor import QTensor
from ._cuda import (
    COUNTS,
    check,
    library,
    require,
    sm_count,
    split_counters,
    split_workspace,
    stream_ptr,
)

_FMT_PACKED4, _FMT_U8, _FMT_S8, _FMT_E4M3 = 0, 1, 2, 3
FP8_NAME = "w8_matmul_e4m3"  # the W8 kernel's e4m3 form's launch count


def _kernel_name(qt) -> str:
    """The launch count's name: the W4 or W8 kernel, ``_wide`` for its
    wide-group forms (groups over 32: GPTQ, AWQ), ``w4_matmul_g16`` for W4
    at group 16 (Q2_K), ``w8_matmul_e4m3`` for an FP8 weight."""
    if isinstance(qt, Fp8Tensor):
        return FP8_NAME
    if qt.packed and qt.group_size == 16:
        return "w4_matmul_g16"
    return ("w4_matmul" if qt.packed else "w8_matmul") + ("_wide" if qt.group_size > 32 else "")


def quant_matmul_plain(
    x2: torch.Tensor, qt, compute_dtype=torch.bfloat16, out_dtype=None
) -> torch.Tensor:
    """Plain PyTorch version: dequantize, round to ``compute_dtype``, f32
    matmul (an FP8 weight: JAX ``fp8_matmul``). ``x2`` is ``[M, K]``;
    returns ``[M, N]`` in ``out_dtype``."""
    COUNTS[_kernel_name(qt) + "_plain"] += 1
    w = qt.dequantize(torch.float32).to(compute_dtype)  # [N, K]
    out = x2.to(compute_dtype).to(torch.float32) @ w.to(torch.float32).T
    return out.to(out_dtype or x2.dtype)


def group_error(packed: bool, gs: int, k: int) -> Optional[str]:
    """Why the W4 (``packed``) or W8 kernel refuses groups of ``gs`` over
    ``K = k``, or None where it takes them."""
    if packed and not (gs in (16, 32, 64, 128) and (k // 2) % gs == 0):
        return (f"the W4 kernel takes group size 16, 32, 64 or 128 dividing K/2 = {k // 2}; "
                f"not {gs}")
    if not packed and not (gs in (16, 32, 64) or (gs % 128 == 0 and k % gs == 0)):
        return (f"the W8 kernel takes group size 16, 32, 64, or a multiple of 128 dividing "
                f"K = {k}; not {gs}")
    return None


def _check_planes(qt: QTensor) -> int:
    """Validate ``qt``'s planes for the CUDA kernels (one matrix or a bank)
    and return the kernel's code format."""
    n, k = qt.out_features, qt.in_features
    lead = tuple(qt.data.shape[:-2])
    why = group_error(qt.packed, qt.group_size, k)
    require(why is None, why)
    require(k % 128 == 0 and n % 16 == 0,
            f"kernel needs K % 128 == 0 and N % 16 == 0, got K={k}, N={n}")
    require(qt.scale.dtype == torch.float32 and qt.scale.is_contiguous()
            and tuple(qt.scale.shape) == (*lead, k // qt.group_size, n), "bad scale plane")
    planes = [qt.data, qt.scale]
    if qt.bias is not None:
        require(qt.bias.dtype == torch.float32 and qt.bias.is_contiguous()
                and qt.bias.shape == qt.scale.shape, "bad bias plane")
        planes.append(qt.bias)
    require(qt.data.is_contiguous(), "code plane must be contiguous")
    require(all(p.device == qt.data.device and p.data_ptr() % 16 == 0 for p in planes),
            "planes must share a device and start at 16-byte aligned addresses")
    if qt.packed:
        require(qt.data.dtype == torch.uint8, "packed codes must be uint8")
        return _FMT_PACKED4
    require(qt.data.dtype in (torch.uint8, torch.int8), "codes must be (u)int8")
    return _FMT_S8 if qt.data.dtype == torch.int8 else _FMT_U8


def _check_fp8(w: Fp8Tensor) -> int:
    """Validate an FP8 weight's planes for the W8 kernel's e4m3 form and
    return its code format."""
    k, n = w.data.shape
    gs = w.group_size
    require(gs == 64 or (gs % 128 == 0 and k % gs == 0),
            f"the W8 kernel's e4m3 form takes a block of 64 or a multiple of 128 rows of K "
            f"dividing K = {k} (a per-tensor scale: K); not {gs}")
    require(k % 128 == 0 and n % 16 == 0,
            f"kernel needs K % 128 == 0 and N % 16 == 0, got K={k}, N={n}")
    require(w.data.dtype == torch.float8_e4m3fn and w.data.is_contiguous(),
            "e4m3 codes must be a contiguous float8_e4m3fn [K, N] plane")
    require(w.plane.dtype == torch.float32 and w.plane.is_contiguous()
            and tuple(w.plane.shape) == (k // gs, n), "bad scale plane")
    require(w.plane.device == w.data.device and w.data.data_ptr() % 16 == 0
            and w.plane.data_ptr() % 16 == 0,
            "planes must share a device and start at 16-byte aligned addresses")
    return _FMT_E4M3


def _plane_format(qt) -> int:
    """The kernels' code format of ``qt`` (a QTensor or an Fp8Tensor), its
    planes validated on its first call only: both are frozen, so they
    cannot change after."""
    fmt = qt.__dict__.get("_kernel_format")
    if fmt is None:
        fmt = _check_fp8(qt) if isinstance(qt, Fp8Tensor) else _check_planes(qt)
        object.__setattr__(qt, "_kernel_format", fmt)
    return fmt


def _bf16_rows(x2: torch.Tensor) -> torch.Tensor:
    """``x2`` as contiguous bf16 rows at a 16-byte-aligned address."""
    x2 = x2.to(torch.bfloat16).contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


# ---------------------------------------------------------------------------
# the kernels' plans
# ---------------------------------------------------------------------------

DECODE_STEP = 128  # logical K per decode step (W4: 64 packed byte rows; W8: 128 rows)
DECODE_COLUMNS = 64  # output columns per W4 decode block (4 warps)
W8_DECODE_COLUMNS = 128  # per W8 decode block (8 warps: 128-byte code rows)
DECODE_BLOCKS_PER_SM = 2  # the decode grid's floor, so every SM streams codes
DECODE_SPLIT_STEPS = 4  # least steps per split: the decode body's ring depth
PREFILL_STEP = 64  # logical K per W8 prefill step (one stage of its ring)
PREFILL_COLUMNS = 256  # output columns per W8 prefill block
PREFILL_SPLIT_STEPS = 4  # least steps per split of the W8 prefill body
PREFILL_RAMP_STEPS = 4  # a W8 prefill block's ring fill and epilogue, in steps
# rows per W8 prefill block of a grouped call: pairs of one expert's 64-row
# tiles, so each dequantized weight serves up to 128 rows (PERF.md)
W8_GROUPED_PREFILL_TILE = 128

class Plan(NamedTuple):
    body: str  # "decode" (mma.sync, split K); "prefill" (wgmma)
    tile: int  # rows per row tile: decode 8 or 16, prefill 64 or 128
    splits: int  # K splits of one matrix; else 1
    columns: int = DECODE_COLUMNS  # output columns per block


_BODIES = {"decode": 0, "prefill": 1}


def decode_splits(n: int, k: int, sms: int, columns: int = DECODE_COLUMNS) -> int:
    """K splits of the decode body (``csrc/mm_decode.cuh``, W4 and W8 alike)
    for ``w [n, k]`` in blocks of ``columns`` on a card of ``sms`` SMs.

    K is split only when the column tiles alone give fewer than
    ``DECODE_BLOCKS_PER_SM`` blocks per SM. The split count is then the one
    (whole steps each, at least that many blocks, and at least
    ``DECODE_SPLIT_STEPS`` steps a split where K allows, so each split's ring
    fills) that minimises the busiest SM's work,
    ``ceil(blocks / sms) * ceil(steps / splits)`` steps, and the fewest
    splits among equals: every SM streams codes, and no SM holds one block
    more than the others for long."""
    tiles = -(-n // columns)
    steps = k // DECODE_STEP
    floor = DECODE_BLOCKS_PER_SM * sms
    if tiles >= floor:
        return 1
    least = min(-(-floor // tiles), steps)
    return min(range(least, max(least, steps // DECODE_SPLIT_STEPS) + 1),
               key=lambda s: (-(-tiles * s // sms) * -(-steps // s), s))


def prefill_cost(m: int, n: int, k: int, tile: int, splits: int, sms: int, gs: int = 32,
                 bias: bool = False) -> float:
    """What the busiest SM reads from L2, in bytes, when the W8 prefill body
    runs ``x [m, k] @ w.T`` (``w [n, k]``, groups of ``gs``, a bias plane or
    not) in ``tile``-row blocks of ``PREFILL_COLUMNS`` columns with K in
    ``splits``: the body is bound by those reads (PERF.md), one block
    an SM (its ring fills the SM's shared memory). Each of its waves of
    blocks reads a stage (x, codes, scale and bias rows: one row each for
    groups of 64 and more) per step, plus
    ``PREFILL_RAMP_STEPS`` for filling its ring and its epilogue; the K
    splits' f32 partials are written and read back once, spread over the
    card."""
    tiles = -(-m // tile) * -(-n // PREFILL_COLUMNS)
    stage = (tile * PREFILL_STEP * 2 + PREFILL_STEP * PREFILL_COLUMNS
             + -(-PREFILL_STEP // gs) * PREFILL_COLUMNS * 4 * (2 if bias else 1))
    waves = -(-tiles * splits // sms)
    per_split = -(-(k // PREFILL_STEP) // splits)
    partials = 0 if splits == 1 else 2 * splits * m * n * 4 / sms
    return waves * (per_split + PREFILL_RAMP_STEPS) * stage + partials


def prefill_tile_splits(m: int, n: int, k: int, sms: int, gs: int = 32,
                        bias: bool = False) -> tuple[int, int]:
    """The W8 prefill body's row tile and K splits for one matrix: among
    64-row tiles (and 128-row ones when ``m > 64``) and the split counts
    that give every SM a block (none when the tiles alone do; whole steps,
    at least ``PREFILL_SPLIT_STEPS`` a split where K allows), the one of the
    least :func:`prefill_cost`; fewer splits, then the smaller tile, among
    equals."""
    steps = k // PREFILL_STEP
    best = None
    for tile in (64, 128) if m > 64 else (64,):
        tiles = -(-m // tile) * -(-n // PREFILL_COLUMNS)
        least = 1 if tiles >= sms else min(-(-sms // tiles), steps)
        for s in range(least, max(least, steps // PREFILL_SPLIT_STEPS) + 1):
            key = (prefill_cost(m, n, k, tile, s, sms, gs, bias), s, tile)
            best = key if best is None or key < best else best
    return best[2], best[1]


@functools.lru_cache(maxsize=1024)
def w4_plan(m: int, n: int, k: int, tm: Optional[int] = None, sms: int = 132) -> Plan:
    """The W4 kernel's body, row tile and K splits for ``x [m, k] @ w.T``
    with ``w [n, k]`` (``tm``: the grouped form's row tile) on a card of
    ``sms`` SMs. A row tile of at most 16 rows takes the decode body, split
    as :func:`decode_splits` says; larger tiles take the wgmma prefill body."""
    if tm is not None:
        require(tm in GROUPED_TILES, f"row tile {tm} not in {GROUPED_TILES}")
        return Plan("decode", 16, 1) if tm == 16 else Plan("prefill", 64, 1)
    if m > 16:
        return Plan("prefill", 64 if m <= 64 else 128, 1)
    return Plan("decode", 8 if m <= 8 else 16, decode_splits(n, k, sms))


def _w8_decode_columns(tiles: int, steps: int, n: int, sms: int) -> int:
    """Blocks of ``W8_DECODE_COLUMNS`` (each code row a block reads is one
    128-byte line) where ``tiles`` row tiles of them, with K split into
    ``steps`` single steps at most, reach the ``DECODE_BLOCKS_PER_SM`` floor;
    else the W4 body's 64-column blocks."""
    wide = -(-n // W8_DECODE_COLUMNS) * tiles * steps >= DECODE_BLOCKS_PER_SM * sms
    return W8_DECODE_COLUMNS if wide else DECODE_COLUMNS


@functools.lru_cache(maxsize=1024)
def w8_plan(m: int, n: int, k: int, sms: int = 132, tm: Optional[int] = None, gs: int = 32,
            bias: bool = False) -> Plan:
    """The W8 kernel's body for ``x [m, k] @ w.T`` (``tm``: the grouped
    form's row tile) on a card of ``sms`` SMs.

    A row tile of at most 16 rows takes the decode body of
    ``csrc/w8_matmul.cu`` (the W4 decode body's): one matrix split by the
    same rule, the grouped form's 16-row tiles one split each. Its blocks are
    ``W8_DECODE_COLUMNS`` wide where that can reach the
    ``DECODE_BLOCKS_PER_SM`` floor (for one matrix with K split into single
    steps; for a bank over all ``m / 16`` tiles, the used tiles' worst
    case), else 64 (Mixtral's ``attn_v``, N = 1024).

    More rows take the wgmma prefill body in blocks of ``PREFILL_COLUMNS``:
    for one matrix (groups of ``gs``, a bias plane or not) in the row tile
    and K splits :func:`prefill_tile_splits` picks; for a bank in
    ``W8_GROUPED_PREFILL_TILE`` rows (pairs of one expert's 64-row tiles)."""
    if tm is not None:
        require(tm in GROUPED_TILES, f"row tile {tm} not in {GROUPED_TILES}")
        if tm == 16:
            return Plan("decode", 16, 1, _w8_decode_columns(m // 16, 1, n, sms))
        return Plan("prefill", W8_GROUPED_PREFILL_TILE, 1, PREFILL_COLUMNS)
    if m > 16:
        tile, splits = prefill_tile_splits(m, n, k, sms, gs, bias)
        return Plan("prefill", tile, splits, PREFILL_COLUMNS)
    columns = _w8_decode_columns(1, k // DECODE_STEP, n, sms)
    return Plan("decode", 8 if m <= 8 else 16, decode_splits(n, k, sms, columns), columns)


def split_steps(k: int, splits: int, step: int = DECODE_STEP) -> list[tuple[int, int]]:
    """The steps ``[begin, end)`` of each split, as the kernels compute them:
    split ``j`` takes steps ``[j * s // splits, (j + 1) * s // splits)`` of
    ``s = k / step`` (decode: 128; W8 prefill: ``PREFILL_STEP``)."""
    s = k // step
    return [(j * s // splits, (j + 1) * s // splits) for j in range(splits)]


def w4_split_rows(k: int, splits: int) -> list[tuple[int, int]]:
    """The packed byte rows ``[begin, end)`` of each split of the W4 decode
    body (64 byte rows a step)."""
    half = DECODE_STEP // 2
    return [(a * half, b * half) for a, b in split_steps(k, splits)]


def split_sizes(plan: Plan, m: int, n: int) -> tuple[int, int]:
    """The split-K state a call of ``plan`` on ``x [m, k]`` into ``[m, n]``
    takes: ``splits * m * n`` f32 workspace values and one int32 counter per
    column tile (the decode body's: zero between calls, the last block of a
    tile resets its counter; the W8 prefill body sums its splits in a second
    kernel); none for one split."""
    if plan.splits == 1:
        return 0, 0
    return plan.splits * m * n, -(-n // plan.columns)


def _plan(qt, m: int, sms: int, tm: Optional[int] = None) -> Plan:
    n, k = qt.out_features, qt.in_features
    if qt.packed:
        return w4_plan(m, n, k, tm, sms)
    return w8_plan(m, n, k, sms, tm, qt.group_size, qt.bias is not None)


def _matrices(weights):
    """The single quantized matrices of a weight tree (dicts, lists,
    tensors, QTensors, Fp8Tensors)."""
    if isinstance(weights, dict):
        weights = list(weights.values())
    if isinstance(weights, list):
        return [qt for w in weights for qt in _matrices(w)]
    one = isinstance(weights, (QTensor, Fp8Tensor)) and weights.num_banks is None
    return [weights] if one else []


def split_need_tree(weights, rows, sms: int) -> tuple[int, int]:
    """The largest split-K state (:func:`split_sizes`: workspace floats and
    counters, each its own largest) that :func:`quant_matmul` takes on a
    card of ``sms`` SMs for any single quantized matrix of a weight tree at
    any row count of ``rows`` (the grouped forms never split K)."""
    floats = counters = 0
    for qt in _matrices(weights):
        for m in rows:
            f, c = split_sizes(_plan(qt, m, sms), m, qt.out_features)
            floats, counters = max(floats, f), max(counters, c)
    return floats, counters


def _split_buffers(device: torch.device, plan: Plan, m: int, n: int):
    """The split-K state of :func:`split_sizes` on ``device``; ``(None,
    None)`` for one split."""
    floats, counters = split_sizes(plan, m, n)
    if not floats:
        return None, None
    return split_workspace(device, floats), split_counters(device, counters)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bank_strides(qt: QTensor) -> tuple[int, int]:
    """The code (bytes) and scale/bias (floats) strides of a bank's experts;
    zero for one matrix."""
    if qt.num_banks is None:
        return 0, 0
    return qt.data[0].numel(), qt.scale[0].numel()


def _w4_launch(x2: torch.Tensor, qt: QTensor, out: torch.Tensor, out_bf16: bool,
               tile_idx: Optional[torch.Tensor] = None,
               n_used: Optional[torch.Tensor] = None, tm: Optional[int] = None) -> int:
    """Launch the W4 kernel on ``x2 [m, k]`` (rows sorted into ``tm``-row
    tiles for a bank) into ``out``; returns the CUDA error code."""
    m, k = x2.shape
    n = out.shape[1]
    plan = _plan(qt, m, sm_count(x2.device), tm)
    ws, cnt = _split_buffers(x2.device, plan, m, n)
    return library().mrt_w4_matmul(
        x2.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), _ptr(qt.bias), out.data_ptr(),
        _ptr(tile_idx), _ptr(n_used), m, n, k, qt.group_size, int(out_bf16),
        _BODIES[plan.body], plan.tile,
        plan.splits, *_bank_strides(qt), _ptr(ws), _ptr(cnt), stream_ptr(x2),
    )


def _w8_launch(x2: torch.Tensor, qt, fmt: int, out: torch.Tensor, out_bf16: bool,
               tile_idx: Optional[torch.Tensor] = None,
               n_used: Optional[torch.Tensor] = None, tm: Optional[int] = None) -> int:
    """Launch the W8 kernel's body that :func:`w8_plan` picks on ``x2 [m,
    k]`` (rows sorted into ``tm``-row tiles for a bank) into ``out``;
    returns the CUDA error code. An FP8 weight gives its expanded scale
    plane as the kernel's."""
    m, k = x2.shape
    n = out.shape[1]
    plan = _plan(qt, m, sm_count(x2.device), tm)
    ws, cnt = _split_buffers(x2.device, plan, m, n)
    scale = qt.plane if fmt == _FMT_E4M3 else qt.scale
    return library().mrt_w8_matmul(
        x2.data_ptr(), qt.data.data_ptr(), scale.data_ptr(), _ptr(qt.bias), out.data_ptr(),
        _ptr(tile_idx), _ptr(n_used), m, n, k, qt.group_size, fmt, int(out_bf16),
        _BODIES[plan.body], plan.tile, plan.splits, plan.columns, *_bank_strides(qt),
        _ptr(ws), _ptr(cnt), stream_ptr(x2),
    )


def _quant_matmul_cuda(x2: torch.Tensor, qt, compute_dtype, out_dtype) -> torch.Tensor:
    m = x2.shape[0]
    n = qt.out_features
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, not {compute_dtype}")
    if qt.data.device != x2.device:
        raise ValueError("weight and input on different devices")
    fmt = _plane_format(qt)
    x2 = _bf16_rows(x2)
    out_bf16 = out_dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=x2.device)
    if m == 0:
        return out.to(out_dtype)
    name = _kernel_name(qt)
    if fmt == _FMT_PACKED4:
        code = _w4_launch(x2, qt, out, out_bf16)
    else:
        code = _w8_launch(x2, qt, fmt, out, out_bf16)
    check(code, name)
    COUNTS[name] += 1
    COUNTS[f"{name}.{_plan(qt, m, sm_count(x2.device)).body}"] += 1  # the body it ran
    return out if out.dtype == out_dtype else out.to(out_dtype)


def quant_matmul(
    x: torch.Tensor,
    qt: QTensor | Fp8Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """``x @ w.T`` for quantized ``w = [N, K]`` (planar or FP8); ``x`` is
    ``[..., K]``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor, or
    ``plain=True``, runs the plain version."""
    *batch, k = x.shape
    if qt.num_banks is not None:
        raise ValueError("quant_matmul takes one matrix; a bank goes to quant_matmul_grouped")
    if k != qt.in_features:
        raise ValueError(f"x K={k} != weight K={qt.in_features}")
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    if plain or x.device.type == "cpu":
        out = quant_matmul_plain(x2, qt, compute_dtype, out_dtype)
    elif x.device.type == "cuda":
        out = _quant_matmul_cuda(x2, qt, compute_dtype, out_dtype)
    else:
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    return out.reshape(*batch, qt.out_features)


# ---------------------------------------------------------------------------
# grouped (MoE) form over a bank of experts
# ---------------------------------------------------------------------------

GROUPED_TILES = (16, 64)


def check_groups(x2: torch.Tensor, tile_idx: torch.Tensor,
                 n_used_tiles: torch.Tensor, tm: int) -> torch.Tensor:
    """Validate a grouped call's row tiling for the CUDA kernels and return
    the used-tile count as one int32 on the device. ``tile_idx`` values must
    lie in [0, E): ``build_groups`` clips them, and the kernels read them
    without a host round trip."""
    mp = x2.shape[0]
    if tm not in GROUPED_TILES:
        raise ValueError(f"row tile {tm} not in {GROUPED_TILES}")
    if mp % tm:
        raise ValueError(f"{mp} rows are not whole tiles of {tm}")
    require(tile_idx.dtype == torch.int32 and tile_idx.is_contiguous()
            and tile_idx.shape == (mp // tm,) and tile_idx.device == x2.device,
            "tile_idx must be contiguous int32 [rows / tm] on the input's device")
    require(n_used_tiles.dtype == torch.int32 and n_used_tiles.numel() == 1
            and n_used_tiles.device == x2.device,
            "n_used_tiles must be one int32 on the input's device")
    return n_used_tiles.reshape(1).contiguous()


def used_tile_rows(tile_idx: torch.Tensor, n_used_tiles: torch.Tensor,
                   tm: int) -> dict[int, torch.Tensor]:
    """Plain versions' view of a grouped tiling: for each expert a used tile
    names, the row indices of its tiles (host round trip; never on the
    card's main path)."""
    tiles = tile_idx.tolist()
    rows: dict[int, list[int]] = {}
    for t, e in enumerate(tiles[:int(n_used_tiles.reshape(-1)[0])]):
        rows.setdefault(int(e), []).extend(range(t * tm, (t + 1) * tm))
    return {e: torch.tensor(r, dtype=torch.long, device=tile_idx.device)
            for e, r in sorted(rows.items())}


def quant_matmul_grouped_plain(
    x2: torch.Tensor, qt: QTensor, tile_idx: torch.Tensor, *, tm: int,
    n_used_tiles: torch.Tensor, compute_dtype=torch.bfloat16,
    out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernels: each used tile's expert
    dequantized as :func:`quant_matmul_plain` does it (f32, one rounding to
    ``compute_dtype``), then an f32 product; tiles at or past
    ``n_used_tiles`` are zero."""
    COUNTS[_kernel_name(qt) + "_g_plain"] += 1
    mp = x2.shape[0]
    out = torch.zeros((mp, qt.out_features), dtype=torch.float32, device=x2.device)
    xf = x2.to(compute_dtype).to(torch.float32)
    for e, rows in used_tile_rows(tile_idx, n_used_tiles, tm).items():
        w = qt.bank(e).dequantize(torch.float32).to(compute_dtype).to(torch.float32)
        out[rows] = xf[rows] @ w.T
    return out.to(out_dtype or x2.dtype)


def _quant_matmul_grouped_cuda(
    x2: torch.Tensor, qt: QTensor, tile_idx: torch.Tensor,
    n_used_tiles: torch.Tensor, tm: int, compute_dtype, out_dtype,
) -> torch.Tensor:
    mp, k = x2.shape
    n = qt.out_features
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, not {compute_dtype}")
    if qt.data.device != x2.device:
        raise ValueError("weight and input on different devices")
    fmt = _plane_format(qt)
    n_used = check_groups(x2, tile_idx, n_used_tiles, tm)
    x2 = _bf16_rows(x2)
    out_bf16 = out_dtype == torch.bfloat16
    out = torch.empty((mp, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=x2.device)
    if mp == 0:
        return out.to(out_dtype)
    name = _kernel_name(qt) + "_g"
    if fmt == _FMT_PACKED4:
        code = _w4_launch(x2, qt, out, out_bf16, tile_idx, n_used, tm)
    else:
        code = _w8_launch(x2, qt, fmt, out, out_bf16, tile_idx, n_used, tm)
    check(code, name)
    COUNTS[name] += 1
    COUNTS[f"{name}.{_plan(qt, mp, sm_count(x2.device), tm).body}"] += 1  # the body it ran
    return out if out.dtype == out_dtype else out.to(out_dtype)


def quant_matmul_grouped(
    x: torch.Tensor,
    qt: QTensor,
    tile_idx: torch.Tensor,
    *,
    tm: int,
    n_used_tiles: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """Grouped ``x @ w[tile_idx[t]].T`` over a bank ``qt [E, N, K]``.

    ``x`` is ``[T*tm, K]`` (rows sorted by expert, each group padded to a
    ``tm`` multiple); ``tile_idx`` is ``[T]`` int32, the expert of every row
    tile; tiles at or past ``n_used_tiles`` (one int32 on the device, from
    ``build_groups``) come out zero. A CUDA tensor launches the kernel (or raises); a CPU tensor, or
    ``plain=True``, runs the plain version."""
    if qt.num_banks is None:
        raise ValueError("quant_matmul_grouped takes a bank [E, N, K]")
    if x.dim() != 2 or x.shape[1] != qt.in_features or x.shape[0] % tm:
        raise ValueError(f"x {tuple(x.shape)} is not [T*{tm}, {qt.in_features}]")
    out_dtype = out_dtype or x.dtype
    if plain or x.device.type == "cpu":
        return quant_matmul_grouped_plain(x, qt, tile_idx, tm=tm, n_used_tiles=n_used_tiles,
                                          compute_dtype=compute_dtype, out_dtype=out_dtype)
    if x.device.type == "cuda":
        return _quant_matmul_grouped_cuda(x, qt, tile_idx, n_used_tiles, tm,
                                          compute_dtype, out_dtype)
    raise ValueError(f"quant_matmul_grouped: unsupported device {x.device}")
