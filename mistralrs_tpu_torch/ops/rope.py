"""Rotary position embeddings (counterpart of ``mistralrs_tpu/ops/rope.py``):
the default and llama3-scaled frequencies with HF rotate-half pairing.
Other scaling kinds raise ``NotImplementedError``."""

from __future__ import annotations

import math
from typing import Any, Optional

import torch


def rope_frequencies(
    head_dim: int, theta: float = 10000.0, scaling: Optional[dict[str, Any]] = None,
    device=None,
) -> torch.Tensor:
    """Per-pair inverse frequencies [head_dim // 2] (f32)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if not scaling:
        return inv_freq
    kind = scaling.get("rope_type") or scaling.get("type") or "default"
    if kind in ("default", "none"):
        return inv_freq
    if kind != "llama3":
        raise NotImplementedError(f"rope scaling type {kind!r}")
    factor = float(scaling["factor"])
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = orig / low
    high_wl = orig / high
    smooth = (orig / wavelen - low) / (high - low)
    return torch.where(
        wavelen > low_wl,
        inv_freq / factor,
        torch.where(
            wavelen < high_wl, inv_freq,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [...] int → (cos, sin) each [..., head_dim // 2] f32."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE over the whole head. x: [..., n_heads, head_dim];
    cos/sin: [..., head_dim // 2] (positions of shape x.shape[:-2])."""
    half = cos.shape[-1]
    if 2 * half != x.shape[-1]:
        raise NotImplementedError("partial rotary embeddings")
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
