"""GGUF container reader (multi-file aware).

A copy of ``mistralrs_tpu/gguf/reader.py``: parses header, metadata KV
section and tensor index, reads raw tensor bytes, and joins split files
(``model-00001-of-00003.gguf``) into one namespace. It reads with plain
file reads, never a memory map: on some machines a map of the file makes
the whole file resident in the process. A loader that reads each tensor
onto the card holds one chunk of it on the host at a time.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from .._device import DeviceLike, read_bytes
from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    row_byte_size,
)

_SPLIT_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # logical (numpy/row-major) shape, outermost first
    ggml_type: GGMLType
    offset: int  # absolute byte offset of the data within its file
    file_index: int = 0

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def byte_size(self) -> int:
        return row_byte_size(self.ggml_type, self.n_elements)


class _Truncated(Exception):
    """The parser ran past the end of its buffer."""


class _Parser:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_string(self) -> str:
        n = self.read("Q")
        if self.pos + n > len(self.buf):
            raise _Truncated
        s = bytes(self.buf[self.pos : self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def read_value(self, vtype: GGUFValueType) -> Any:
        t = GGUFValueType(vtype)
        scalar_fmt = {
            GGUFValueType.UINT8: "B",
            GGUFValueType.INT8: "b",
            GGUFValueType.UINT16: "H",
            GGUFValueType.INT16: "h",
            GGUFValueType.UINT32: "I",
            GGUFValueType.INT32: "i",
            GGUFValueType.FLOAT32: "f",
            GGUFValueType.UINT64: "Q",
            GGUFValueType.INT64: "q",
            GGUFValueType.FLOAT64: "d",
        }
        if t in scalar_fmt:
            return self.read(scalar_fmt[t])
        if t == GGUFValueType.BOOL:
            return bool(self.read("B"))
        if t == GGUFValueType.STRING:
            return self.read_string()
        if t == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.read("I"))
            n = self.read("Q")
            # fast path for large numeric arrays (e.g. tokenizer merges/scores)
            np_map = {
                GGUFValueType.UINT8: np.uint8,
                GGUFValueType.INT8: np.int8,
                GGUFValueType.UINT16: np.uint16,
                GGUFValueType.INT16: np.int16,
                GGUFValueType.UINT32: np.uint32,
                GGUFValueType.INT32: np.int32,
                GGUFValueType.FLOAT32: np.float32,
                GGUFValueType.UINT64: np.uint64,
                GGUFValueType.INT64: np.int64,
                GGUFValueType.FLOAT64: np.float64,
            }
            if elem_type in np_map:
                dt = np.dtype(np_map[elem_type]).newbyteorder("<")
                if self.pos + n * dt.itemsize > len(self.buf):
                    raise _Truncated
                arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=self.pos)
                self.pos += arr.nbytes
                return arr.tolist()
            return [self.read_value(elem_type) for _ in range(n)]
        raise ValueError(f"unknown GGUF value type {vtype}")


@dataclass
class GGUFFile:
    """A single parsed .gguf file."""

    path: Path
    metadata: dict[str, Any]
    tensors: dict[str, TensorInfo]
    alignment: int
    data_offset: int

    @classmethod
    def open(cls, path: str | os.PathLike, file_index: int = 0) -> "GGUFFile":
        """Parse ``path``'s header from its first bytes (1 MiB, doubled
        until the header fits)."""
        path = Path(path)
        size = os.path.getsize(path)
        n = min(size, 1 << 20)
        while True:
            with open(path, "rb") as f:
                head = f.read(n)
            try:
                return cls._parse(path, head, file_index)
            except (_Truncated, struct.error):  # the header runs past the bytes read
                if n >= size:
                    raise ValueError(f"{path}: GGUF header runs past the end of the file") \
                        from None
                n = min(size, 2 * n)

    @classmethod
    def _parse(cls, path: Path, head: bytes, file_index: int) -> "GGUFFile":
        p = _Parser(head)
        magic = p.read("I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        version = p.read("I")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors = p.read("Q")
        n_kv = p.read("Q")
        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = p.read_string()
            vtype = GGUFValueType(p.read("I"))
            metadata[key] = p.read_value(vtype)
        alignment = int(metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        tensors: dict[str, TensorInfo] = {}
        pending = []
        for _ in range(n_tensors):
            name = p.read_string()
            n_dims = p.read("I")
            # GGUF stores dims innermost-first; we expose numpy order.
            dims = [p.read("Q") for _ in range(n_dims)]
            ggml_type = GGMLType(p.read("I"))
            rel_offset = p.read("Q")
            pending.append((name, tuple(reversed(dims)), ggml_type, rel_offset))
        data_offset = (p.pos + alignment - 1) // alignment * alignment
        for name, shape, ggml_type, rel_offset in pending:
            tensors[name] = TensorInfo(
                name=name,
                shape=shape,
                ggml_type=ggml_type,
                offset=data_offset + rel_offset,
                file_index=file_index,
            )
        return cls(
            path=path,
            metadata=metadata,
            tensors=tensors,
            alignment=alignment,
            data_offset=data_offset,
        )

    def tensor_bytes(self, name: str, device: DeviceLike = None):
        """The tensor's raw data read from the file: a new writable uint8
        array, or with ``device`` a flat uint8 tensor there (on a card
        copied in chunks, so the host holds one chunk, not the tensor)."""
        info = self.tensors[name]
        out = read_bytes(self.path, info.offset, info.byte_size, device or "cpu", name)
        return out.numpy() if device is None else out

    def close(self):
        """Nothing is held open between reads."""


class GGUFContent:
    """Multi-file GGUF content: one namespace over N split files.

    Mirrors the capability of the reference's `Content::from_readers`
    (`mistralrs-core/src/gguf/content.rs:73`): metadata merged (first file
    wins on conflicts except `split.*` bookkeeping), tensor index unioned.
    """

    def __init__(self, files: list[GGUFFile]):
        if not files:
            raise ValueError("no GGUF files")
        self.files = files
        self.metadata: dict[str, Any] = {}
        for f in reversed(files):
            self.metadata.update(f.metadata)
        self.tensors: dict[str, TensorInfo] = {}
        for i, f in enumerate(files):
            for name, info in f.tensors.items():
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name!r} across GGUF splits")
                self.tensors[name] = info

    @classmethod
    def open(cls, path: str | os.PathLike) -> "GGUFContent":
        path = Path(path)
        m = _SPLIT_RE.match(path.name)
        paths = [path]
        if m:
            stem, _idx, total = m.group(1), int(m.group(2)), int(m.group(3))
            paths = [
                path.parent / f"{stem}-{i:05d}-of-{total:05d}.gguf"
                for i in range(1, total + 1)
            ]
        files = [GGUFFile.open(p, file_index=i) for i, p in enumerate(paths)]
        return cls(files)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def tensor_info(self, name: str) -> TensorInfo:
        return self.tensors[name]

    def tensor_bytes(self, name: str, device: DeviceLike = None):
        info = self.tensors[name]
        return self.files[info.file_index].tensor_bytes(name, device)

    def dequantize(self, name: str) -> np.ndarray:
        """Load a tensor fully dequantized to float32 (host)."""
        from .planar import dequantize

        info = self.tensors[name]
        return dequantize(self.tensor_bytes(name), info.ggml_type, info.shape).numpy()

    def close(self):
        for f in self.files:
            f.close()

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "unknown")
