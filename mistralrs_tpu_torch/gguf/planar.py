"""GGUF block formats → planar (q, scale, bias) decomposition.

The port's copy of ``mistralrs_tpu/gguf/planar.py:73-177`` (with the index
maps and helpers of ``mistralrs_tpu/gguf/quants.py`` it uses) for all ten
types the JAX package decomposes:

    value[k] = scale[k // group_size] * q[k] + bias[k // group_size]

* ``Q4_0`` / ``Q4_1`` — unsigned 4-bit codes, group 32, bias ``-8 d`` / ``m``;
* ``Q5_0`` / ``Q5_1`` — unsigned 5-bit codes, group 32, bias ``-16 d`` / ``m``;
* ``Q8_0`` — signed int8 codes, group 32, no bias;
* ``Q2_K`` — unsigned 2-bit codes, group 16, scale and "min" bias;
* ``Q3_K`` — signed codes in [-4, 3] (int8), group 16, no bias;
* ``Q4_K`` / ``Q5_K`` — unsigned 4-/5-bit codes, group 32, scale and "min"
  bias;
* ``Q6_K`` — signed codes in [-32, 31] (int8), group 16, no bias.

The decompositions are torch integer ops (gathers, shifts, masks) and
f16 → f32 conversions on a ``uint8`` tensor, and run on that tensor's
device: the GGUF loader copies a tensor's raw blocks to the card and decodes
them there, so a 30 G-weight checkpoint is not decoded by the host. Every
scale and bias is an exact f32 product of an f16 and a small integer (at
most 17 significant bits), so the decomposition is bit-exact against the
GGUF spec wherever it runs. Other types raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .constants import QK_K, GGMLType, type_traits

Raw = Union[np.ndarray, torch.Tensor]


@dataclass
class PlanarQuant:
    """Flat planar decomposition of a quantized tensor (torch, on the raw
    bytes' device; numpy arrays are accepted where one is built by hand)."""

    q: torch.Tensor  # [n_elements] int8 or uint8 integer codes
    scale: torch.Tensor  # [n_groups] float32
    bias: Optional[torch.Tensor]  # [n_groups] float32, or None (symmetric)
    group_size: int
    code_bits: int  # bit-width of the codes (2..8)
    signed: bool  # True → q is int8 codes; False → uint8 codes

    def dequantize(self) -> torch.Tensor:
        q, scale = torch.as_tensor(self.q), torch.as_tensor(self.scale)
        g = q.to(torch.float32).reshape(-1, self.group_size)
        out = scale[:, None] * g
        if self.bias is not None:
            out = out + torch.as_tensor(self.bias)[:, None]
        return out.reshape(-1)


def as_bytes(raw: Raw) -> torch.Tensor:
    """Raw tensor bytes as a flat ``uint8`` tensor: a torch tensor as it is
    (on its device), a numpy array (a read-only view of a file's map is
    copied first) on the CPU."""
    if isinstance(raw, torch.Tensor):
        if raw.dtype != torch.uint8:
            raise TypeError(f"raw bytes must be uint8, not {raw.dtype}")
        return raw.reshape(-1)
    a = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _blocks(raw: Raw, t: GGMLType) -> torch.Tensor:
    tr = type_traits(t)
    b = as_bytes(raw)
    if b.numel() % tr.type_size != 0:
        raise ValueError(f"raw size {b.numel()} not divisible by {tr.type_size}")
    return b.reshape(-1, tr.type_size)


def _f16(b: torch.Tensor) -> torch.Tensor:
    """A [n, 2] uint8 slice as little-endian float16 → float32 [n, 1]."""
    return b.contiguous().view(torch.float16).to(torch.float32)


def _idx(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """An index or shift map on ``like``'s device."""
    return torch.from_numpy(a).to(like.device)


def _nibbles32(qs: torch.Tensor) -> torch.Tensor:
    """[n, 16] bytes → [n, 32] 4-bit values: the low nibbles, then the high."""
    return torch.cat([qs & 15, qs >> 4], dim=1)


def _unpack_scale_min_k4(scales12: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack the 12-byte packed 6-bit (scale, min) pairs of Q4_K / Q5_K.
    Returns (sc, mn), each [n_blocks, 8] uint8."""
    s = scales12
    sc = [s[:, g] & 63 for g in range(4)]
    mn = [s[:, g + 4] & 63 for g in range(4)]
    sc += [(s[:, g + 4] & 15) | ((s[:, g - 4] >> 6) << 4) for g in range(4, 8)]
    mn += [(s[:, g + 4] >> 4) | ((s[:, g] >> 6) << 4) for g in range(4, 8)]
    return torch.stack(sc, dim=1), torch.stack(mn, dim=1)


def _unpack_q3k_scales(scales12: torch.Tensor) -> torch.Tensor:
    """12 packed bytes → [n, 16] signed 6-bit scales (int32; stored as
    value + 32)."""
    s = scales12.to(torch.int32)
    lo = torch.cat([s[:, 0:8] & 15, s[:, 0:8] >> 4], dim=1)
    hi = (s[:, _idx(8 + _Q3K_SC_HI_BYTE, s)] >> _idx(_Q3K_SC_HI_SHIFT, s)) & 3
    return (lo | (hi << 4)) - 32


def _q5_high_bits(qh_bytes: torch.Tensor) -> torch.Tensor:
    """[n, 4] uint8 → [n, 32]: bit j of the little-endian u32."""
    return (qh_bytes[:, _idx(_Q5_BIT_BYTE, qh_bytes)] >> _idx(_Q5_BIT_SHIFT, qh_bytes)) & 1


# element → (byte, shift) index maps of the block layouts
_LOCAL = np.arange(QK_K)
_Q4K_POS = _LOCAL % 64
_Q4K_BYTE = (_LOCAL // 64) * 32 + _Q4K_POS % 32
_Q4K_HI = (_Q4K_POS >= 32).astype(np.uint8) * 4  # shift: 0 (lo) or 4 (hi)

_Q5K_HI_BYTE = _LOCAL % 32
_Q5K_HI_SHIFT = (_LOCAL // 32).astype(np.uint8)

_Q6K_HALF = _LOCAL // 128
_Q6K_POS = _LOCAL % 32
_Q6K_QUARTER = (_LOCAL % 128) // 32
_Q6K_QL_BYTE = _Q6K_HALF * 64 + _Q6K_POS + (_Q6K_QUARTER % 2) * 32
_Q6K_QL_SHIFT = (_Q6K_QUARTER >= 2).astype(np.uint8) * 4
_Q6K_QH_BYTE = _Q6K_HALF * 32 + _Q6K_POS
_Q6K_QH_SHIFT = (_Q6K_QUARTER * 2).astype(np.uint8)

_Q2K_BYTE = _LOCAL // 128 * 32 + _LOCAL % 32
_Q2K_SHIFT = ((_LOCAL % 128) // 32 * 2).astype(np.uint8)

_Q3K_HM_BYTE = _LOCAL % 32
_Q3K_HM_SHIFT = (_LOCAL // 32).astype(np.uint8)
# scale g's two high bits: byte 8 + g % 4, at bit 2 (g // 4)
_Q3K_SC_HI_BYTE = np.arange(16) % 4
_Q3K_SC_HI_SHIFT = (2 * (np.arange(16) // 4)).astype(np.int32)

_Q5_BIT_BYTE = np.arange(32) // 8
_Q5_BIT_SHIFT = (np.arange(32) % 8).astype(np.uint8)


def _gather(b: torch.Tensor, byte: np.ndarray, shift: np.ndarray) -> torch.Tensor:
    """``b[:, byte[l]] >> shift[l]`` for every element ``l`` of a super-block."""
    return b[:, _idx(byte, b)] >> _idx(shift, b)


def _planar_q4_0(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q4_0)
    d = _f16(b[:, 0:2])[:, 0]
    q = _nibbles32(b[:, 2:18])
    return PlanarQuant(q.reshape(-1), d, -8.0 * d, 32, 4, False)


def _planar_q4_1(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q4_1)
    d = _f16(b[:, 0:2])[:, 0]
    m = _f16(b[:, 2:4])[:, 0]
    q = _nibbles32(b[:, 4:20])
    return PlanarQuant(q.reshape(-1), d, m, 32, 4, False)


def _planar_q5_0(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q5_0)
    d = _f16(b[:, 0:2])[:, 0]
    q = _nibbles32(b[:, 6:22]) | (_q5_high_bits(b[:, 2:6]) << 4)
    return PlanarQuant(q.reshape(-1), d, -16.0 * d, 32, 5, False)


def _planar_q5_1(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q5_1)
    d = _f16(b[:, 0:2])[:, 0]
    m = _f16(b[:, 2:4])[:, 0]
    q = _nibbles32(b[:, 8:24]) | (_q5_high_bits(b[:, 4:8]) << 4)
    return PlanarQuant(q.reshape(-1), d, m, 32, 5, False)


def _planar_q8_0(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q8_0)
    d = _f16(b[:, 0:2])[:, 0]
    q = b[:, 2:34].contiguous().view(torch.int8)
    return PlanarQuant(q.reshape(-1), d, None, 32, 8, True)


def _planar_q2_k(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q2_K)
    scales = b[:, 0:16]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    q = _gather(b[:, 16:80], _Q2K_BYTE, _Q2K_SHIFT) & 3
    scale = (d * (scales & 15).to(torch.float32)).reshape(-1)  # [n_sb * 16]
    bias = (-dmin * (scales >> 4).to(torch.float32)).reshape(-1)
    return PlanarQuant(q.reshape(-1), scale, bias, 16, 2, False)


def _planar_q3_k(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q3_K)
    sc6 = _unpack_q3k_scales(b[:, 96:108]).to(torch.float32)
    d = _f16(b[:, 108:110])
    lo = _gather(b[:, 32:96], _Q2K_BYTE, _Q2K_SHIFT) & 3
    hi = _gather(b[:, 0:32], _Q3K_HM_BYTE, _Q3K_HM_SHIFT) & 1
    q = (lo | (hi << 2)).to(torch.int8) - 4
    scale = (d * sc6).reshape(-1)  # [n_sb * 16]
    return PlanarQuant(q.reshape(-1), scale, None, 16, 3, True)


def _planar_q4_k(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q4_K)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    q = _gather(b[:, 16:144], _Q4K_BYTE, _Q4K_HI) & 15
    scale = (d * sc.to(torch.float32)).reshape(-1)  # [n_sb * 8]
    bias = (-dmin * mn.to(torch.float32)).reshape(-1)
    return PlanarQuant(q.reshape(-1), scale, bias, 32, 4, False)


def _planar_q5_k(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q5_K)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    lo = _gather(b[:, 48:176], _Q4K_BYTE, _Q4K_HI) & 15
    hi = _gather(b[:, 16:48], _Q5K_HI_BYTE, _Q5K_HI_SHIFT) & 1
    q = lo | (hi << 4)
    scale = (d * sc.to(torch.float32)).reshape(-1)  # [n_sb * 8]
    bias = (-dmin * mn.to(torch.float32)).reshape(-1)
    return PlanarQuant(q.reshape(-1), scale, bias, 32, 5, False)


def _planar_q6_k(raw: Raw) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q6_K)
    sc8 = b[:, 192:208].contiguous().view(torch.int8).to(torch.float32)
    d = _f16(b[:, 208:210])
    lo = _gather(b[:, 0:128], _Q6K_QL_BYTE, _Q6K_QL_SHIFT) & 15
    hi = _gather(b[:, 128:192], _Q6K_QH_BYTE, _Q6K_QH_SHIFT) & 3
    q = (lo | (hi << 4)).to(torch.int8) - 32
    scale = (d * sc8).reshape(-1)  # [n_sb * 16]
    return PlanarQuant(q.reshape(-1), scale, None, 16, 7, True)


_PLANARIZERS = {
    GGMLType.Q4_0: _planar_q4_0,
    GGMLType.Q4_1: _planar_q4_1,
    GGMLType.Q5_0: _planar_q5_0,
    GGMLType.Q5_1: _planar_q5_1,
    GGMLType.Q8_0: _planar_q8_0,
    GGMLType.Q2_K: _planar_q2_k,
    GGMLType.Q3_K: _planar_q3_k,
    GGMLType.Q4_K: _planar_q4_k,
    GGMLType.Q5_K: _planar_q5_k,
    GGMLType.Q6_K: _planar_q6_k,
}

PLANAR_TYPES = frozenset(_PLANARIZERS)


def to_planar(raw: Raw, t: GGMLType) -> PlanarQuant:
    """Decompose raw GGUF tensor bytes (numpy, or a ``uint8`` tensor on any
    device) into the flat planar representation, on the bytes' device."""
    fn = _PLANARIZERS.get(t)
    if fn is None:
        raise NotImplementedError(f"no planar decomposition for {t!r}")
    return fn(raw)


def _dequant_q8_1(raw: Raw) -> torch.Tensor:
    b = _blocks(raw, GGMLType.Q8_1)
    return _f16(b[:, 0:2]) * b[:, 4:36].contiguous().view(torch.int8).to(torch.float32)


def _dequant_q8_k(raw: Raw) -> torch.Tensor:
    b = _blocks(raw, GGMLType.Q8_K)
    d = b[:, 0:4].contiguous().view(torch.float32)
    return d * b[:, 4:260].contiguous().view(torch.int8).to(torch.float32)


# types the JAX package dequantizes to dense weights only (JAX
# gguf/quants.py:104-117): llama.cpp's activation-side 8-bit blocks
DENSE_ONLY_TYPES = {GGMLType.Q8_1: _dequant_q8_1, GGMLType.Q8_K: _dequant_q8_k}


def dequantize(raw: Raw, t: GGMLType, shape: tuple[int, ...]) -> torch.Tensor:
    """Raw GGUF tensor bytes → float32 tensor of ``shape`` on the bytes'
    device (dense types, the planar types above, Q8_1 and Q8_K)."""
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        b = as_bytes(raw).contiguous()
        dt = {GGMLType.F32: torch.float32, GGMLType.F16: torch.float16,
              GGMLType.BF16: torch.bfloat16}[t]
        return b.view(dt).to(torch.float32).reshape(shape)
    if t in DENSE_ONLY_TYPES:
        return DENSE_ONLY_TYPES[t](raw).reshape(shape)
    return to_planar(raw, t).dequantize().reshape(shape)
