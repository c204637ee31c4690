"""GGUF file-format and GGML quantization-type constants.

A copy of ``mistralrs_tpu/gguf/constants.py`` (the port keeps its own copy so
that it imports nothing of the JAX package). Everything here is written from
the GGUF spec.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # super-block size for k-quants
K_SCALE_SIZE = 12


class GGUFValueType(enum.IntEnum):
    """Metadata value types in the GGUF KV section."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (ggml_type enum values from the GGUF spec)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 removed (Q4_2/Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


@dataclass(frozen=True)
class TypeTraits:
    """Block size (elements) and byte size per block for a GGML type."""

    block_size: int
    type_size: int

    @property
    def bits_per_weight(self) -> float:
        return self.type_size * 8 / self.block_size


# block layouts (spec-exact; struct shapes cross-checked against the
# reference's mmq_common.cuh:141-193):
#   Q4_0:  {f16 d;                   u8 qs[16]}                    -> 18 B / 32
#   Q4_1:  {f16 d; f16 m;            u8 qs[16]}                    -> 20 B / 32
#   Q5_0:  {f16 d;        u8 qh[4];  u8 qs[16]}                    -> 22 B / 32
#   Q5_1:  {f16 d; f16 m; u8 qh[4];  u8 qs[16]}                    -> 24 B / 32
#   Q8_0:  {f16 d;                   i8 qs[32]}                    -> 34 B / 32
#   Q8_1:  {f16 d; f16 s;            i8 qs[32]}                    -> 36 B / 32
#   Q2_K:  {u8 scales[16]; u8 qs[64]; f16 d; f16 dmin}             -> 84 B / 256
#   Q3_K:  {u8 hmask[32]; u8 qs[64]; u8 scales[12]; f16 d}         -> 110 B / 256
#   Q4_K:  {f16 d; f16 dmin; u8 scales[12]; u8 qs[128]}            -> 144 B / 256
#   Q5_K:  {f16 d; f16 dmin; u8 scales[12]; u8 qh[32]; u8 qs[128]} -> 176 B / 256
#   Q6_K:  {u8 ql[128]; u8 qh[64]; i8 scales[16]; f16 d}           -> 210 B / 256
#   Q8_K:  {f32 d; i8 qs[256]; i16 bsums[16]}                      -> 292 B / 256
GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4),
    GGMLType.F16: TypeTraits(1, 2),
    GGMLType.BF16: TypeTraits(1, 2),
    GGMLType.F64: TypeTraits(1, 8),
    GGMLType.I8: TypeTraits(1, 1),
    GGMLType.I16: TypeTraits(1, 2),
    GGMLType.I32: TypeTraits(1, 4),
    GGMLType.I64: TypeTraits(1, 8),
    GGMLType.Q4_0: TypeTraits(32, 18),
    GGMLType.Q4_1: TypeTraits(32, 20),
    GGMLType.Q5_0: TypeTraits(32, 22),
    GGMLType.Q5_1: TypeTraits(32, 24),
    GGMLType.Q8_0: TypeTraits(32, 34),
    GGMLType.Q8_1: TypeTraits(32, 36),
    GGMLType.Q2_K: TypeTraits(QK_K, QK_K // 16 + QK_K // 4 + 4),
    GGMLType.Q3_K: TypeTraits(QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: TypeTraits(QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2),
}


def type_traits(t: GGMLType) -> TypeTraits:
    try:
        return GGML_TYPE_TRAITS[t]
    except KeyError:
        raise NotImplementedError(f"GGML type {t!r} is not supported") from None


def row_byte_size(t: GGMLType, n_elements: int) -> int:
    tr = type_traits(t)
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{n_elements} elements not divisible by block size {tr.block_size} for {t!r}"
        )
    return n_elements // tr.block_size * tr.type_size
