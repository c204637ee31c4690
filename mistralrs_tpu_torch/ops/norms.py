"""RMSNorm (counterpart of ``mistralrs_tpu/ops/norms.py::rms_norm``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation (HF Llama semantics), result in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)
