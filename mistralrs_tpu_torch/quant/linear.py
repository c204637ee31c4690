"""Uniform linear-layer dispatch (counterpart of
``mistralrs_tpu/quant/linear.py:35-84``): one entry point for a planar
:class:`QTensor`, an FP8 :class:`Fp8Tensor` or a plain dense ``[out, in]``
tensor."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..ops.quant_matmul import quant_matmul
from .fp8 import Fp8Tensor
from .qtensor import QTensor

Weight = Union[QTensor, Fp8Tensor, torch.Tensor]


def linear(
    x: torch.Tensor,
    w: Weight,
    bias: Optional[torch.Tensor] = None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """``x @ w.T (+ bias)`` with ``w`` of shape [out, in]; f32 accumulation,
    result in ``x.dtype``. A QTensor whose rows were padded for the kernels
    (``logical_n``) gives its first ``logical_n`` outputs."""
    if isinstance(w, (QTensor, Fp8Tensor)):
        # weights dequantize to bf16 whatever x's dtype, as in the JAX
        # package (quant_matmul's default dequant_dtype; fp8_matmul's bf16)
        out = quant_matmul(x, w, plain=plain)
        if w.logical_n is not None:
            out = out[..., :w.logical_n]
    elif isinstance(w, torch.Tensor):
        out = torch.matmul(x, w.to(x.dtype).T)
    else:
        raise NotImplementedError(f"linear: weight type {type(w).__name__}")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def embedding_lookup(ids: torch.Tensor, w: Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather from an embedding table ``[V, H]`` (dense or planar); the
    rows come out contiguous (a planar table's gather is K-major, and a
    strided residual stream slows every norm and add after it)."""
    if isinstance(w, QTensor):
        data = w.data[:, ids].movedim(0, -1).contiguous()  # [ids..., Kd]
        scale = w.scale[:, ids].movedim(0, -1).contiguous()  # [ids..., G]
        bias = None if w.bias is None else w.bias[:, ids].movedim(0, -1).contiguous()
        if w.packed:
            d = data.to(torch.int32)
            codes = torch.cat([d & 15, d >> 4], dim=-1)
        elif w.data.dtype == torch.int8:
            codes = data.to(torch.int32)
        else:
            codes = data.to(torch.int32) & 0xFF
        gs = w.group_size
        g = codes.shape[-1] // gs
        q = codes.to(torch.float32).reshape(*codes.shape[:-1], g, gs)
        out = q * scale[..., None]
        if bias is not None:
            out = out + bias[..., None]
        return out.reshape(codes.shape).to(dtype)
    return w[ids].to(dtype)
