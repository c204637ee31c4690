"""GGUF block formats → planar (q, scale, bias) decomposition.

The port's copy of ``mistralrs_tpu/gguf/planar.py:109-153`` for the three
types the dense llama path reads from Q4_K_M-style files:

    value[k] = scale[k // group_size] * q[k] + bias[k // group_size]

* ``Q4_K`` — unsigned 4-bit codes, group 32, scale and "min" bias;
* ``Q6_K`` — signed codes in [-32, 31] (int8), group 16, no bias;
* ``Q8_0`` — signed int8 codes, group 32, no bias.

Scales and biases are exact f32 products of the f16 super-block scales and
the integer sub-scales, so the decomposition is bit-exact against the GGUF
spec. Other types raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import QK_K, GGMLType, type_traits


@dataclass
class PlanarQuant:
    """Flat planar decomposition of a quantized tensor (numpy, host-side)."""

    q: np.ndarray  # [n_elements] int8 or uint8 integer codes
    scale: np.ndarray  # [n_groups] float32
    bias: np.ndarray | None  # [n_groups] float32, or None (symmetric)
    group_size: int
    code_bits: int  # bit-width of the codes
    signed: bool  # True → q is int8 codes; False → uint8 codes

    def dequantize(self) -> np.ndarray:
        g = self.q.astype(np.float32).reshape(-1, self.group_size)
        out = self.scale[:, None] * g
        if self.bias is not None:
            out = out + self.bias[:, None]
        return out.reshape(-1)


def _f16(b: np.ndarray) -> np.ndarray:
    """View a [n, 2] uint8 slice as little-endian float16 -> float32 [n, 1]."""
    return np.ascontiguousarray(b).view(np.dtype("<f2")).astype(np.float32)


def _blocks(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    tr = type_traits(t)
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if raw.size % tr.type_size != 0:
        raise ValueError(f"raw size {raw.size} not divisible by {tr.type_size}")
    return raw.reshape(-1, tr.type_size)


def _unpack_scale_min_k4(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte packed 6-bit (scale, min) pairs of Q4_K.
    Returns (sc, mn), each [n_blocks, 8] uint8."""
    s = scales12
    sc = np.empty((s.shape[0], 8), dtype=np.uint8)
    mn = np.empty((s.shape[0], 8), dtype=np.uint8)
    for g in range(4):
        sc[:, g] = s[:, g] & 63
        mn[:, g] = s[:, g + 4] & 63
    for g in range(4, 8):
        sc[:, g] = (s[:, g + 4] & 15) | ((s[:, g - 4] >> 6) << 4)
        mn[:, g] = (s[:, g + 4] >> 4) | ((s[:, g] >> 6) << 4)
    return sc, mn


# element → (byte, shift) index maps of the super-block layouts
_LOCAL = np.arange(QK_K)
_Q4K_POS = _LOCAL % 64
_Q4K_BYTE = (_LOCAL // 64) * 32 + _Q4K_POS % 32
_Q4K_HI = (_Q4K_POS >= 32).astype(np.uint8) * 4  # shift: 0 (lo) or 4 (hi)

_Q6K_HALF = _LOCAL // 128
_Q6K_POS = _LOCAL % 32
_Q6K_QUARTER = (_LOCAL % 128) // 32
_Q6K_QL_BYTE = _Q6K_HALF * 64 + _Q6K_POS + (_Q6K_QUARTER % 2) * 32
_Q6K_QL_SHIFT = (_Q6K_QUARTER >= 2).astype(np.uint8) * 4
_Q6K_QH_BYTE = _Q6K_HALF * 32 + _Q6K_POS
_Q6K_QH_SHIFT = (_Q6K_QUARTER * 2).astype(np.uint8)


def _planar_q8_0(raw: np.ndarray) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q8_0)
    d = _f16(b[:, 0:2])[:, 0]
    q = b[:, 2:34].view(np.int8)
    return PlanarQuant(q.reshape(-1).copy(), d, None, 32, 8, True)


def _planar_q4_k(raw: np.ndarray) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q4_K)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    q = (b[:, 16:144][:, _Q4K_BYTE] >> _Q4K_HI[None, :]) & 15
    scale = (d * sc.astype(np.float32)).reshape(-1)  # [n_sb * 8]
    bias = (-dmin * mn.astype(np.float32)).reshape(-1)
    return PlanarQuant(q.reshape(-1), scale, bias, 32, 4, False)


def _planar_q6_k(raw: np.ndarray) -> PlanarQuant:
    b = _blocks(raw, GGMLType.Q6_K)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc8 = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210])
    lo = (ql[:, _Q6K_QL_BYTE] >> _Q6K_QL_SHIFT[None, :]) & 15
    hi = (qh[:, _Q6K_QH_BYTE] >> _Q6K_QH_SHIFT[None, :]) & 3
    q = (lo | (hi << 4)).astype(np.int16) - 32
    scale = (d * sc8).reshape(-1)  # [n_sb * 16]
    return PlanarQuant(q.astype(np.int8).reshape(-1), scale, None, 16, 7, True)


_PLANARIZERS = {
    GGMLType.Q4_K: _planar_q4_k,
    GGMLType.Q6_K: _planar_q6_k,
    GGMLType.Q8_0: _planar_q8_0,
}

PLANAR_TYPES = frozenset(_PLANARIZERS)


def to_planar(raw: np.ndarray, t: GGMLType) -> PlanarQuant:
    """Decompose raw GGUF tensor bytes into the flat planar representation."""
    fn = _PLANARIZERS.get(t)
    if fn is None:
        raise NotImplementedError(f"no planar decomposition for {t!r}")
    return fn(raw)


def dequantize(raw: np.ndarray, t: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Raw GGUF tensor bytes → float32 of ``shape`` (dense types and the
    planar types above)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if t == GGMLType.F32:
        return raw.view("<f4").reshape(shape).copy()
    if t == GGMLType.F16:
        return raw.view("<f2").astype(np.float32).reshape(shape)
    if t == GGMLType.BF16:
        u16 = raw.view("<u2").astype(np.uint32)
        return (u16 << 16).view(np.float32).reshape(shape)
    return to_planar(raw, t).dequantize().reshape(shape)
