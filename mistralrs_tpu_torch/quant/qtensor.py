"""Device-resident quantized tensors (torch counterpart of
``mistralrs_tpu/quant/qtensor.py``).

A :class:`QTensor` holds a weight matrix ``W`` of logical shape ``[N, K]``
(out-features, in-features) in the planar decomposition of
:mod:`mistralrs_tpu_torch.gguf.planar`:

    w[n, k] = scale[k // group_size, n] * q[k, n] + bias[k // group_size, n]

Everything is stored K-major, as in the JAX package: codes ``[K, N]`` and
scales ``[K // gs, N]``. Unsigned codes of at most 4 bits are split-half
packed along K: byte ``j`` holds code ``j`` (low nibble) and code ``j + K/2``
(high nibble), so the 4-bit plane is ``[K/2, N]`` uint8. Scales and biases are
exact f32 products of the GGUF f16 scales and integer sub-scales, so
:meth:`QTensor.dequantize` is bit-identical to the GGUF spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.planar import PlanarQuant, to_planar


@dataclass(frozen=True)
class QTensor:
    """Quantized ``[N, K]`` weight matrix in planar layout."""

    data: torch.Tensor  # uint8 [K//2, N] (packed) or int8/uint8 [K, N]
    scale: torch.Tensor  # f32 [K // group_size, N]
    bias: Optional[torch.Tensor]  # f32 [K // group_size, N] or None
    group_size: int = 32
    packed: bool = False
    code_bits: int = 8
    ggml_type: Optional[GGMLType] = None

    @property
    def shape(self) -> tuple[int, int]:
        kd, n = self.data.shape
        return (n, kd * 2 if self.packed else kd)

    @property
    def out_features(self) -> int:
        return self.shape[0]

    @property
    def in_features(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def signed(self) -> bool:
        return self.data.dtype == torch.int8

    @property
    def nbytes(self) -> int:
        planes = [self.data, self.scale] + ([] if self.bias is None else [self.bias])
        return sum(p.numel() * p.element_size() for p in planes)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_planar(
        cls,
        planar: PlanarQuant,
        shape: tuple[int, int],
        ggml_type: GGMLType | None = None,
        device: torch.device | str = "cpu",
    ) -> "QTensor":
        n, k = shape
        gs = planar.group_size
        if k % gs != 0:
            raise ValueError(f"K={k} not divisible by group size {gs}")
        q = np.ascontiguousarray(planar.q.reshape(n, k).T)  # [K, N]
        scale = np.ascontiguousarray(planar.scale.reshape(n, k // gs).astype(np.float32).T)
        bias = (
            None if planar.bias is None
            else np.ascontiguousarray(planar.bias.reshape(n, k // gs).astype(np.float32).T)
        )
        pack = (not planar.signed) and planar.code_bits <= 4 and (k // 2) % gs == 0
        if pack:
            half = k // 2
            data = (q[:half] | (q[half:] << 4)).astype(np.uint8)
        else:
            data = q.astype(np.int8 if planar.signed else np.uint8)
        return cls(
            data=torch.from_numpy(np.ascontiguousarray(data)).to(device),
            scale=torch.from_numpy(scale).to(device),
            bias=None if bias is None else torch.from_numpy(bias).to(device),
            group_size=gs,
            packed=pack,
            code_bits=planar.code_bits,
            ggml_type=ggml_type,
        )

    @classmethod
    def from_gguf_raw(
        cls, raw: np.ndarray, t: GGMLType, shape: tuple[int, int],
        device: torch.device | str = "cpu",
    ) -> "QTensor":
        return cls.from_planar(to_planar(raw, t), shape, ggml_type=t, device=device)

    def to(self, device) -> "QTensor":
        return QTensor(
            data=self.data.to(device), scale=self.scale.to(device),
            bias=None if self.bias is None else self.bias.to(device),
            group_size=self.group_size, packed=self.packed,
            code_bits=self.code_bits, ggml_type=self.ggml_type,
        )

    # -- access -------------------------------------------------------------

    def unpack_codes(self) -> torch.Tensor:
        """Integer codes as int32 ``[K, N]``."""
        if self.packed:
            d = self.data.to(torch.int32)
            return torch.cat([d & 15, d >> 4], dim=0)
        if self.data.dtype == torch.int8:
            return self.data.to(torch.int32)
        return self.data.to(torch.int32) & 0xFF

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Full dequantization (computed in f32, then cast); logical ``[N, K]``."""
        n, k = self.shape
        g = k // self.group_size
        q = self.unpack_codes().to(torch.float32).reshape(g, self.group_size, n)
        w = q * self.scale[:, None, :]
        if self.bias is not None:
            w = w + self.bias[:, None, :]
        return w.reshape(k, n).T.to(dtype)
