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

A bank of experts carries one leading axis: codes ``[E, K/2, N]`` or
``[E, K, N]``, scales and biases ``[E, K/gs, N]``, contiguous, so expert
``e`` (:meth:`QTensor.bank`) is a view and the grouped kernels find it at a
fixed stride. :meth:`QTensor.stack` makes a bank of single matrices.

The kernels take N in multiples of 16. A matrix of another N (a router of 8
or 60 experts, qwen2moe's shared-expert gate of 1 row) carries its planes
zero-padded to the next multiple (:meth:`QTensor.pad_rows`: zero codes,
scales and biases, so the padded rows compute zeros) and its own N as
``logical_n``; ``quant/linear.py::linear`` slices the product to it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from ..gguf.constants import GGMLType
from ..gguf.planar import PlanarQuant, as_bytes, to_planar


@dataclass(frozen=True)
class QTensor:
    """Quantized ``[N, K]`` weight matrix (or ``[E, N, K]`` bank) in planar
    layout."""

    data: torch.Tensor  # uint8 [(E,) K//2, N] (packed) or int8/uint8 [(E,) K, N]
    scale: torch.Tensor  # f32 [(E,) K // group_size, N]
    bias: Optional[torch.Tensor]  # f32 [(E,) K // group_size, N] or None
    group_size: int = 32
    packed: bool = False
    code_bits: int = 8
    ggml_type: Optional[GGMLType] = None
    logical_n: Optional[int] = None  # the rows before :meth:`pad_rows`; None: all real

    @property
    def shape(self) -> tuple[int, ...]:
        """The planes' shape: ``(N, K)``, or ``(E, N, K)`` for a bank (N
        padded where ``logical_n`` is set)."""
        *lead, kd, n = self.data.shape
        return (*lead, n, kd * 2 if self.packed else kd)

    @property
    def out_features(self) -> int:
        return self.shape[-2]

    @property
    def in_features(self) -> int:
        return self.shape[-1]

    @property
    def num_banks(self) -> Optional[int]:
        """E for a bank of experts, None for one matrix."""
        return self.data.shape[0] if self.data.dim() == 3 else None

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
        shape: tuple[int, ...],
        ggml_type: GGMLType | None = None,
        device: DeviceLike = None,
    ) -> "QTensor":
        """Planes of a ``[N, K]`` matrix or an ``[E, N, K]`` bank (GGUF row
        order) on ``device`` (``cuda`` unless the caller asks for ``"cpu"``).
        The planes (torch tensors on any device, or numpy) are moved to
        ``device`` first, then laid out K-major and packed there. Unsigned
        codes of at most 4 bits pack into nibbles where ``(K / 2) %
        group_size == 0``, as in the JAX package: Q4_0/Q4_1/Q4_K at group 32
        and Q2_K's 2-bit codes at group 16."""
        dev = resolve_device(device)
        *lead, n, k = shape
        if len(lead) > 1:
            raise ValueError(f"shape {shape}: at most one bank axis")
        e = lead[0] if lead else 1
        gs = planar.group_size
        if k % gs != 0:
            raise ValueError(f"K={k} not divisible by group size {gs}")

        def kmajor(a, cols):  # [E*N*cols] → [E, cols, N] on the device
            return torch.as_tensor(a).to(dev).reshape(e, n, cols).transpose(1, 2).contiguous()

        q = kmajor(planar.q, k)
        scale = kmajor(planar.scale, k // gs).to(torch.float32)
        bias = None if planar.bias is None else kmajor(planar.bias, k // gs).to(torch.float32)
        pack = (not planar.signed) and planar.code_bits <= 4 and (k // 2) % gs == 0
        if pack:
            half = k // 2
            data = q[:, :half].to(torch.uint8) | (q[:, half:].to(torch.uint8) << 4)
        else:
            data = q.to(torch.int8 if planar.signed else torch.uint8)

        def put(a):
            return a if lead else a[0]

        return cls(
            data=put(data),
            scale=put(scale),
            bias=None if bias is None else put(bias),
            group_size=gs,
            packed=pack,
            code_bits=planar.code_bits,
            ggml_type=ggml_type,
        )

    @classmethod
    def from_gguf_raw(
        cls, raw, t: GGMLType, shape: tuple[int, ...],
        device: DeviceLike = None,
    ) -> "QTensor":
        """Raw GGUF bytes (numpy, or a ``uint8`` tensor) → planes on
        ``device``; the bytes are copied there first and decoded there."""
        dev = resolve_device(device)
        return cls.from_planar(to_planar(as_bytes(raw).to(dev), t), shape, ggml_type=t,
                               device=dev)

    @classmethod
    def stack(cls, qts) -> "QTensor":
        """A bank ``[E, N, K]`` of E single matrices of one shape, group size,
        packing and code type (the decoded experts of a GPTQ or AWQ layer),
        each plane stacked along a new leading axis."""
        first = qts[0]
        if first.num_banks is not None or first.logical_n is not None:
            raise ValueError("QTensor.stack takes single unpadded matrices, not banks")
        for qt in qts:
            if (qt.shape, qt.group_size, qt.packed, qt.code_bits, qt.data.dtype,
                    qt.bias is None) != (first.shape, first.group_size, first.packed,
                                         first.code_bits, first.data.dtype, first.bias is None):
                raise ValueError(f"QTensor.stack: {qt.shape} group {qt.group_size} "
                                 f"(packed {qt.packed}, {qt.data.dtype}) does not match "
                                 f"{first.shape} group {first.group_size} (packed "
                                 f"{first.packed}, {first.data.dtype})")
        return cls(
            data=torch.stack([qt.data for qt in qts]),
            scale=torch.stack([qt.scale for qt in qts]),
            bias=None if first.bias is None else torch.stack([qt.bias for qt in qts]),
            group_size=first.group_size, packed=first.packed,
            code_bits=first.code_bits, ggml_type=first.ggml_type,
        )

    def to(self, device) -> "QTensor":
        return dataclasses.replace(
            self, data=self.data.to(device), scale=self.scale.to(device),
            bias=None if self.bias is None else self.bias.to(device))

    def pad_rows(self, multiple: int = 16) -> "QTensor":
        """One matrix with N zero-padded to a multiple of ``multiple`` (zero
        codes, scales and biases: the padded rows compute zeros), its N kept
        as ``logical_n``; itself where N is a multiple already."""
        if self.num_banks is not None:
            raise ValueError("pad_rows takes one matrix, not a bank")
        n = self.out_features
        pad = -n % multiple
        if pad == 0:
            return self

        def padded(p):
            return None if p is None else torch.nn.functional.pad(p, (0, pad)).contiguous()

        return dataclasses.replace(self, data=padded(self.data), scale=padded(self.scale),
                                   bias=padded(self.bias), logical_n=n)

    # -- access -------------------------------------------------------------

    def bank(self, e: int) -> "QTensor":
        """Expert ``e`` of a bank, as a view."""
        if self.num_banks is None:
            raise ValueError("not a bank of experts")
        return dataclasses.replace(self, data=self.data[e], scale=self.scale[e],
                                   bias=None if self.bias is None else self.bias[e])

    def unpack_codes(self) -> torch.Tensor:
        """Integer codes as int32 ``[(E,) K, N]``."""
        if self.packed:
            d = self.data.to(torch.int32)
            return torch.cat([d & 15, d >> 4], dim=-2)
        if self.data.dtype == torch.int8:
            return self.data.to(torch.int32)
        return self.data.to(torch.int32) & 0xFF

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Full dequantization (computed in f32, then cast); logical
        ``[N, K]``, or ``[E, N, K]`` for a bank (each bank on its own)."""
        *lead, n, k = self.shape
        g = k // self.group_size
        q = self.unpack_codes().to(torch.float32).reshape(*lead, g, self.group_size, n)
        w = q * self.scale[..., :, None, :]
        if self.bias is not None:
            w = w + self.bias[..., :, None, :]
        return w.reshape(*lead, k, n).transpose(-1, -2).to(dtype)
