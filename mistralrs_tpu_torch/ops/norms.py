"""Normalisations (counterpart of ``mistralrs_tpu/ops/norms.py``:
``rms_norm``, ``rms_norm_gemma`` and ``layer_norm``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with f32 accumulation (HF Llama
    semantics), result in x.dtype: a layer's hidden states ``[..., H]`` with
    an ``[H]`` weight, or Qwen3's per-head q/k norm, ``[b, t, heads,
    head_dim]`` with a ``[head_dim]`` weight (JAX ``rms_norm`` on the same
    shapes, in the same dtype steps)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def rms_norm_gemma(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma's RMSNorm: the weight is stored as ``w - 1`` and applied as
    ``1 + w``, the sum taken in f32 (not in the weight's dtype)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (phi2, starcoder2, stablelm, cohere): the
    mean and the biased variance in f32, then ``weight`` and the optional
    ``bias`` in f32, result in x.dtype (JAX ``layer_norm``, the same dtype
    steps)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)
