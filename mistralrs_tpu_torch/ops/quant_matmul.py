"""Fused dequant + matmul (counterpart of ``mistralrs_tpu/ops/quant_matmul.py``).

``quant_matmul(x, qt)`` computes ``x @ w.T`` for a planar-quantized weight
``w = [N, K]``. On a CUDA tensor it launches the hand-written kernel of
``csrc/quant_matmul.cu``: the **W4 kernel** for split-half packed 4-bit codes
(Q4_K; replaces ``_w4_matmul``/``_w4_matmul_l``) and the **W8 kernel** for one
byte per code (Q8_0, Q6_K; replaces ``_w8_matmul``/``_w8_matmul_l``). On a CPU
tensor it runs :func:`quant_matmul_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX package and the card's
smoke run holds the kernels against.

Both compute ``w = compute_dtype(scale * q + bias)`` (f32 multiply and add,
then one rounding) and accumulate ``x · w`` in f32. The k-quant "min" bias is
folded into the dequantized weight, as the JAX package's XLA path does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.qtensor import QTensor
from ._cuda import COUNTS, check, library, require, stream_ptr

_FMT_PACKED4, _FMT_U8, _FMT_S8 = 0, 1, 2


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


def _quant_matmul_cuda(
    x2: torch.Tensor, qt: QTensor, compute_dtype, out_dtype
) -> torch.Tensor:
    m, k = x2.shape
    n = qt.out_features
    require(compute_dtype == torch.bfloat16,
            f"the CUDA kernel computes in bf16, not {compute_dtype}")
    require(qt.data.device == x2.device, "weight and input on different devices")
    require(qt.group_size in (16, 32), f"group size {qt.group_size} not in (16, 32)")
    require(k % 128 == 0 and n % 16 == 0,
            f"kernel needs K % 128 == 0 and N % 16 == 0, got K={k}, N={n}")
    require(qt.scale.dtype == torch.float32 and qt.scale.is_contiguous()
            and tuple(qt.scale.shape) == (k // qt.group_size, n), "bad scale plane")
    if qt.bias is not None:
        require(qt.bias.dtype == torch.float32 and qt.bias.is_contiguous()
                and qt.bias.shape == qt.scale.shape, "bad bias plane")
    require(qt.data.is_contiguous(), "code plane must be contiguous")
    if qt.packed:
        require(qt.data.dtype == torch.uint8, "packed codes must be uint8")
        fmt = _FMT_PACKED4
    else:
        require(qt.data.dtype in (torch.uint8, torch.int8), "codes must be (u)int8")
        fmt = _FMT_S8 if qt.data.dtype == torch.int8 else _FMT_U8
    x2 = x2.to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
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
