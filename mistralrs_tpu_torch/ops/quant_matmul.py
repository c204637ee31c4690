"""Fused dequant + matmul (counterpart of ``mistralrs_tpu/ops/quant_matmul.py``).

``quant_matmul(x, qt)`` computes ``x @ w.T`` for a planar-quantized weight
``w = [N, K]``. On a CUDA tensor it launches the hand-written kernel of
``csrc/quant_matmul.cu``: the **W4 kernel** for split-half packed 4-bit codes
(Q4_K; replaces ``_w4_matmul``/``_w4_matmul_l``) and the **W8 kernel** for one
byte per code (Q8_0, Q6_K; replaces ``_w8_matmul``/``_w8_matmul_l``). On a CPU
tensor it runs :func:`quant_matmul_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX package and the card's
smoke run holds the kernels against.

``quant_matmul_grouped(x, bank, tile_idx, ...)`` is the grouped (MoE) form
over a bank ``[E, N, K]``: row-tile ``t`` of ``x`` multiplies expert
``tile_idx[t]``. On a CUDA tensor it launches the **W4 grouped kernel**
(replaces ``_w4_matmul_g``) or the **W8 grouped kernel** (replaces
``_w8_matmul_g``), the same CUDA body with a bank offset; on a CPU tensor it
runs :func:`quant_matmul_grouped_plain`. The same body takes a bf16 bank as a
fourth code format (``ops.moe_grouped.dense_matmul_grouped``).

All compute ``w = compute_dtype(scale * q + bias)`` (f32 multiply and add,
then one rounding) and accumulate ``x · w`` in f32. The k-quant "min" bias is
folded into the dequantized weight, as the JAX package's XLA path does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.qtensor import QTensor
from ._cuda import COUNTS, check, library, require, stream_ptr

_FMT_PACKED4, _FMT_U8, _FMT_S8, _FMT_BF16 = 0, 1, 2, 3


def _kernel_name(qt: QTensor) -> str:
    return "w4_matmul" if qt.packed else "w8_matmul"


def quant_matmul_plain(
    x2: torch.Tensor, qt: QTensor, compute_dtype=torch.bfloat16, out_dtype=None
) -> torch.Tensor:
    """Plain PyTorch version: dequantize, round to ``compute_dtype``, f32
    matmul. ``x2`` is ``[M, K]``; returns ``[M, N]`` in ``out_dtype``."""
    COUNTS[_kernel_name(qt) + "_plain"] += 1
    w = qt.dequantize(torch.float32).to(compute_dtype)  # [N, K]
    out = x2.to(compute_dtype).to(torch.float32) @ w.to(torch.float32).T
    return out.to(out_dtype or x2.dtype)


def _plane_format(qt: QTensor, n: int, k: int) -> int:
    """Validate ``qt``'s planes for the CUDA kernels (one matrix or a bank)
    and return the kernel's code format."""
    lead = tuple(qt.data.shape[:-2])
    require(qt.group_size in (16, 32), f"group size {qt.group_size} not in (16, 32)")
    require(k % 128 == 0 and n % 16 == 0,
            f"kernel needs K % 128 == 0 and N % 16 == 0, got K={k}, N={n}")
    require(qt.scale.dtype == torch.float32 and qt.scale.is_contiguous()
            and tuple(qt.scale.shape) == (*lead, k // qt.group_size, n), "bad scale plane")
    if qt.bias is not None:
        require(qt.bias.dtype == torch.float32 and qt.bias.is_contiguous()
                and qt.bias.shape == qt.scale.shape, "bad bias plane")
    require(qt.data.is_contiguous(), "code plane must be contiguous")
    if qt.packed:
        require(qt.data.dtype == torch.uint8, "packed codes must be uint8")
        return _FMT_PACKED4
    require(qt.data.dtype in (torch.uint8, torch.int8), "codes must be (u)int8")
    return _FMT_S8 if qt.data.dtype == torch.int8 else _FMT_U8


def _bf16_rows(x2: torch.Tensor) -> torch.Tensor:
    """``x2`` as contiguous bf16 rows at a 16-byte-aligned address."""
    x2 = x2.to(torch.bfloat16).contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


def _quant_matmul_cuda(
    x2: torch.Tensor, qt: QTensor, compute_dtype, out_dtype
) -> torch.Tensor:
    m, k = x2.shape
    n = qt.out_features
    require(compute_dtype == torch.bfloat16,
            f"the CUDA kernel computes in bf16, not {compute_dtype}")
    require(qt.data.device == x2.device, "weight and input on different devices")
    fmt = _plane_format(qt, n, k)
    x2 = _bf16_rows(x2)
    out_bf16 = out_dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=x2.device)
    if m == 0:
        return out.to(out_dtype)
    lib = library()
    code = lib.mrt_quant_matmul(
        x2.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(),
        None if qt.bias is None else qt.bias.data_ptr(), out.data_ptr(),
        m, n, k, qt.group_size, fmt, int(out_bf16), stream_ptr(x2),
    )
    check(code, _kernel_name(qt))
    COUNTS[_kernel_name(qt)] += 1
    return out if out.dtype == out_dtype else out.to(out_dtype)


def quant_matmul(
    x: torch.Tensor,
    qt: QTensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """``x @ w.T`` for quantized ``w = [N, K]``; ``x`` is ``[..., K]``.

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
    the used-tile count as one int32 on the device. ``tile_idx`` values must lie in [0, E): ``build_groups`` clips them, and
    the kernels read them without a host round trip."""
    mp = x2.shape[0]
    require(tm in GROUPED_TILES, f"row tile {tm} not in {GROUPED_TILES}")
    require(mp % tm == 0, f"{mp} rows are not whole tiles of {tm}")
    require(tile_idx.dtype == torch.int32 and tile_idx.is_contiguous()
            and tuple(tile_idx.shape) == (mp // tm,) and tile_idx.device == x2.device,
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
    require(compute_dtype == torch.bfloat16,
            f"the CUDA kernel computes in bf16, not {compute_dtype}")
    require(qt.data.device == x2.device, "weight and input on different devices")
    require(qt.num_banks is not None, "quant_matmul_grouped takes a bank [E, N, K]")
    fmt = _plane_format(qt, n, k)
    n_used = check_groups(x2, tile_idx, n_used_tiles, tm)
    x2 = _bf16_rows(x2)
    out_bf16 = out_dtype == torch.bfloat16
    out = torch.empty((mp, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=x2.device)
    if mp == 0:
        return out.to(out_dtype)
    name = _kernel_name(qt) + "_g"
    code = library().mrt_quant_matmul_grouped(
        x2.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(),
        None if qt.bias is None else qt.bias.data_ptr(), out.data_ptr(),
        tile_idx.data_ptr(), n_used.data_ptr(), mp, n, k, qt.group_size, fmt,
        int(out_bf16), tm, qt.data[0].numel(), qt.scale[0].numel(), stream_ptr(x2),
    )
    check(code, name)
    COUNTS[name] += 1
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
