"""GGUF container writer (counterpart of ``mistralrs_tpu/gguf/writer.py``):
the ``quantize`` command's output and test fixtures; GGUF v3, the JAX
``GGUFWriter``'s bytes for the same tensors and metadata.

Tensors are kept as given (torch tensors on any device) until
:meth:`GGUFWriter.write`, which lays out the header from their shapes and
types, then quantizes each tensor on its own device
(``gguf/quants.py::quantize``; F32, F16 and BF16 by rounding) and streams
its bytes to the file, one tensor on the host at a time.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    row_byte_size,
)
from ..models.hf_loader import write_bytes
from .quants import quantize

_NP_SCALAR_TYPES = {
    np.uint8: GGUFValueType.UINT8, np.int8: GGUFValueType.INT8,
    np.uint16: GGUFValueType.UINT16, np.int16: GGUFValueType.INT16,
    np.uint32: GGUFValueType.UINT32, np.int32: GGUFValueType.INT32,
    np.uint64: GGUFValueType.UINT64, np.int64: GGUFValueType.INT64,
    np.float32: GGUFValueType.FLOAT32, np.float64: GGUFValueType.FLOAT64,
    np.bool_: GGUFValueType.BOOL,
}
_FORMATS = {
    GGUFValueType.UINT8: "B", GGUFValueType.INT8: "b", GGUFValueType.UINT16: "H",
    GGUFValueType.INT16: "h", GGUFValueType.UINT32: "I", GGUFValueType.INT32: "i",
    GGUFValueType.FLOAT32: "f", GGUFValueType.UINT64: "Q", GGUFValueType.INT64: "q",
    GGUFValueType.FLOAT64: "d",
}
_DENSE = {GGMLType.F32: torch.float32, GGMLType.F16: torch.float16,
          GGMLType.BF16: torch.bfloat16}


def _infer_value_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if type(v) in _NP_SCALAR_TYPES:
        return _NP_SCALAR_TYPES[type(v)]
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


def tensor_bytes(x: torch.Tensor, t: GGMLType,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x``'s data as type ``t``'s raw bytes (flat uint8 on ``x``'s
    device): F32/F16/BF16 by rounding, the quantized types by
    ``gguf/quants.py::quantize`` (with importance ``weights``)."""
    if t in _DENSE:
        return x.to(_DENSE[t]).contiguous().reshape(-1).view(torch.uint8)
    return quantize(x, t, weights)


class GGUFWriter:
    def __init__(self, path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        # (name, shape, type, float data or None, raw bytes or None, weights)
        self._tensors: list[tuple] = []

    def add_metadata(self, key: str, value: Any, vtype: Optional[GGUFValueType] = None):
        self._kv.append((key, vtype or _infer_value_type(value), value))

    def add_tensor(self, name: str, data: torch.Tensor, ggml_type: Optional[GGMLType] = None,
                   weights: Optional[torch.Tensor] = None):
        """A float tensor, quantized to ``ggml_type`` (F32 by default) when
        the file is written (with importance ``weights``, Q4_K/Q5_K)."""
        ggml_type = GGMLType.F32 if ggml_type is None else ggml_type
        self._tensors.append((name, tuple(int(d) for d in data.shape), ggml_type, data, None,
                              weights))

    def add_raw_tensor(self, name: str, raw, shape: tuple[int, ...], ggml_type: GGMLType):
        """Raw blocks (numpy or a uint8 tensor) of a tensor of ``shape``."""
        raw = torch.as_tensor(np.ascontiguousarray(raw, dtype=np.uint8)
                              if not isinstance(raw, torch.Tensor) else raw).reshape(-1)
        expected = row_byte_size(ggml_type, math.prod(shape))
        if raw.numel() != expected:
            raise ValueError(f"raw size {raw.numel()} != expected {expected}")
        self._tensors.append((name, tuple(int(d) for d in shape), ggml_type, None, raw, None))

    def _string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _value(self, vtype: GGUFValueType, v: Any) -> bytes:
        if vtype in _FORMATS:
            return struct.pack("<" + _FORMATS[vtype], v)
        if vtype == GGUFValueType.BOOL:
            return struct.pack("<B", 1 if v else 0)
        if vtype == GGUFValueType.STRING:
            return self._string(v)
        if vtype == GGUFValueType.ARRAY:
            seq = list(v)
            if seq and isinstance(seq[0], str):
                elem = GGUFValueType.STRING
            elif seq and isinstance(seq[0], bool):
                elem = GGUFValueType.BOOL
            elif seq and isinstance(seq[0], float):
                elem = GGUFValueType.FLOAT32
            else:
                elem = GGUFValueType.INT32
            return struct.pack("<IQ", int(elem), len(seq)) + b"".join(
                self._value(elem, item) for item in seq)
        raise TypeError(f"unsupported metadata type {vtype}")

    def write(self) -> Path:
        out = bytearray(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors),
                                    len(self._kv)))
        for key, vtype, v in self._kv:
            out += self._string(key) + struct.pack("<I", int(vtype)) + self._value(vtype, v)
        rel = 0
        for name, shape, t, *_ in self._tensors:  # offsets relative to the data section
            dims = tuple(reversed(shape))  # GGUF stores innermost-first
            out += self._string(name) + struct.pack("<I", len(dims))
            out += b"".join(struct.pack("<Q", d) for d in dims)
            out += struct.pack("<IQ", int(t), rel)
            rel += -(-row_byte_size(t, math.prod(shape)) // self.alignment) * self.alignment
        out += b"\x00" * (-len(out) % self.alignment)
        with open(self.path, "wb") as f:
            f.write(out)
            for name, shape, t, data, raw, weights in self._tensors:
                if raw is None:
                    raw = tensor_bytes(data, t, weights)
                n = write_bytes(f, raw)
                f.write(b"\x00" * (-n % self.alignment))
        return self.path
