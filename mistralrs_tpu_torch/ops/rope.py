"""Rotary position embeddings (counterpart of ``mistralrs_tpu/ops/rope.py``):
the default, linear-scaled (Gemma-3's global layers), llama3-scaled and
YaRN frequencies, applied with the HF rotate-half pairing or the GLM/GPT-J
interleaved one, over the whole head or its leading dims (partial rotary),
and YaRN's attention factor (:func:`yarn_attention_factor`, which the
decoder folds into cos and sin as the JAX package does). Other scaling kinds
raise ``NotImplementedError``."""

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
    if kind == "linear":  # positions divided by the factor (JAX ops/rope.py:44-45)
        return inv_freq / float(scaling["factor"])
    if kind == "yarn":
        return _yarn(inv_freq, head_dim, theta, scaling)
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


def _yarn(inv_freq: torch.Tensor, head_dim: int, theta: float, scaling: dict[str, Any]):
    """YaRN's frequencies (JAX ``ops/rope.py:65-85``): dims below the fast
    correction dim keep their frequency, dims above the slow one are
    divided by ``factor``, a linear ramp between (``truncate``, default
    true, rounds the correction dims outward to integers)."""
    factor = float(scaling["factor"])
    orig = float(scaling.get("original_max_position_embeddings", 4096))
    beta_fast = float(scaling.get("beta_fast", 32.0))
    beta_slow = float(scaling.get("beta_slow", 1.0))

    def correction_dim(num_rot: float) -> float:
        return (head_dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    dims = torch.arange(head_dim // 2, dtype=torch.float32, device=inv_freq.device)
    # ramp 0: a high-frequency dim (extrapolated, unscaled); 1: a low one (/ factor)
    ramp = torch.clamp((dims - low) / max(high - low, 1e-3), 0.0, 1.0)
    return inv_freq / factor * ramp + inv_freq * (1.0 - ramp)


def yarn_attention_factor(scaling: Optional[dict[str, Any]]) -> float:
    """YaRN's mscale, ``0.1 ln(factor) + 1`` (1.0 without YaRN or with a
    factor of at most 1): a copy of JAX ``yarn_attention_factor``."""
    if not scaling:
        return 1.0
    kind = scaling.get("rope_type") or scaling.get("type")
    if kind != "yarn":
        return 1.0
    factor = float(scaling["factor"])
    if factor <= 1.0:
        return 1.0
    return 0.1 * math.log(factor) + 1.0


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [...] int → (cos, sin) each [..., head_dim // 2] f32."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               interleaved: bool = False) -> torch.Tensor:
    """RoPE over the leading ``2 * cos.shape[-1]`` dims of each head; the
    dims past them pass through (partial rotary: phi2, stablelm, glm's
    ``partial_rotary_factor``). x: [..., n_heads, head_dim]; cos/sin:
    [..., rot // 2] (positions of shape x.shape[:-2]). The HF rotate-half
    pairing (j, j + rot / 2), or with ``interleaved`` the GLM/GPT-J pairing
    (2j, 2j + 1) (JAX ``apply_rope``, the same f32 steps)."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    if interleaved:
        x1 = x_rot[..., 0::2].to(torch.float32)
        x2 = x_rot[..., 1::2].to(torch.float32)
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        out = out.reshape(x_rot.shape).to(x.dtype)
    else:
        x1 = x_rot[..., :rot // 2].to(torch.float32)
        x2 = x_rot[..., rot // 2:].to(torch.float32)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    if x_pass.shape[-1] == 0:
        return out
    return torch.cat([out, x_pass], dim=-1)
