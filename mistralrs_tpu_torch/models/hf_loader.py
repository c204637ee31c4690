"""Hugging Face safetensors reader (counterpart of
``mistralrs_tpu/models/hf_loader.py::load_safetensors_dir``), with its own
parser: the ``safetensors`` package is not needed.

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(plus an optional ``__metadata__`` entry), then the raw little-endian data,
offsets counted from the end of the header. A directory holds one file or
the shards named by ``model.safetensors.index.json``.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file as a CPU tensor in its own
    dtype (F32, F16 or BF16; other dtypes raise). The file is memory-mapped
    and each tensor copied out of it."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{path.name}: {name} has dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        raw = torch.from_numpy(np.array(data[begin:end]))  # a copy, owned by torch
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def load_safetensors_dir(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """All tensors of a model directory: the shards of
    ``model.safetensors.index.json`` where it exists, else every
    ``*.safetensors`` file."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        files = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        files = [path / f for f in files]
    else:
        files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors
