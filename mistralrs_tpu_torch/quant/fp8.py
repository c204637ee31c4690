"""FP8 weights (counterpart of ``mistralrs_tpu/quant/fp8.py``): e4m3 storage
with a per-tensor or a blockwise (``bn x bk``, DeepSeek-style 128 x 128)
scale.

The port stores the codes K-major, ``[K, N]`` ``torch.float8_e4m3fn``, as the
W8 kernel reads its byte planes (the JAX package stores ``[N, K]``; the UQFF
files of both packages hold ``[N, K]``, ``uqff.py`` transposes), and keeps the
scale as the JAX package does: a 0-dim f32 (per tensor) or ``[ceil(N/bn),
ceil(K/bk)]`` f32 (blockwise). Beside it, :attr:`Fp8Tensor.plane` is the same
scale as the W8 kernel's f32 scale plane ``[ceil(K/gs), N]``: a group of
``gs = bk`` rows of K (per tensor: one group of K) and one value per column,
each block's scale repeated over its ``bn`` columns.

:func:`fp8_matmul` computes ``x @ w.T`` through ``ops/quant_matmul.py``'s
``quant_matmul``: on a CUDA tensor the W8 kernel's e4m3 form (groups of 64
or a multiple of 128 dividing K, K % 128 == 0 and N % 16 == 0, else it
raises); on a CPU tensor, or with ``plain=True``, the plain version, JAX
``fp8_matmul``: each weight dequantized in f32 (``code * scale``), rounded
once to bf16, and an f32 product.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .._device import DeviceLike, resolve_device

E4M3_MAX = 448.0


def scale_plane(scale: torch.Tensor, block_shape: Optional[tuple[int, int]], n: int,
                k: int) -> tuple[torch.Tensor, int]:
    """``(plane [ceil(K/gs), N] f32, gs)``: a scale as the W8 kernel's scale
    plane (per tensor: one group of K; blockwise: groups of ``bk``)."""
    if block_shape is None:
        return scale.to(torch.float32).reshape(1, 1).expand(1, n).contiguous(), k
    bn, _ = block_shape
    plane = scale.to(torch.float32).T.repeat_interleave(bn, dim=1)[:, :n]
    return plane.contiguous(), block_shape[1]


@dataclass(frozen=True)
class Fp8Tensor:
    """An ``[N, K]`` weight in e4m3, codes stored K-major ``[K, N]``."""

    data: torch.Tensor  # float8_e4m3fn [K, N]
    scale: torch.Tensor  # f32 [] (per tensor) or [ceil(N/bn), ceil(K/bk)]
    block_shape: Optional[tuple[int, int]] = None  # (bn, bk) when blockwise
    plane: torch.Tensor = dataclasses.field(init=False, repr=False)  # [ceil(K/gs), N] f32
    group_size: int = dataclasses.field(init=False)  # rows of K per plane row

    # as a planar QTensor's, for the W8 kernel's launch: one matrix, one
    # byte per code, no bias plane, no padded rows
    bias = None
    num_banks = None
    packed = False
    logical_n = None

    def __post_init__(self):
        k, n = self.data.shape
        plane, gs = scale_plane(self.scale, self.block_shape, n, k)
        object.__setattr__(self, "plane", plane)
        object.__setattr__(self, "group_size", gs)

    @property
    def shape(self) -> tuple[int, int]:
        k, n = self.data.shape
        return (n, k)

    @property
    def out_features(self) -> int:
        return self.data.shape[1]

    @property
    def in_features(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        """The weight's bytes, as JAX ``Fp8Tensor.nbytes`` counts them: the
        codes and the block (or per-tensor) scales. The kernel reads the
        expanded :attr:`plane` instead: at 128 x 128 blocks 4 bytes per 128
        codes more (3.1 %)."""
        return self.data.numel() + self.scale.numel() * 4

    @classmethod
    def from_nk(cls, data_nk: torch.Tensor, scale: torch.Tensor,
                block_shape: Optional[tuple[int, int]] = None) -> "Fp8Tensor":
        """From ``[N, K]`` codes (the JAX package's and the files' layout)."""
        return cls(data_nk.T.contiguous(), scale.to(torch.float32),
                   None if block_shape is None else tuple(int(b) for b in block_shape))

    @classmethod
    def quantize(cls, w: torch.Tensor, block_shape: Optional[tuple[int, int]] = None,
                 device: DeviceLike = None) -> "Fp8Tensor":
        """An ``[N, K]`` float weight quantized on ``device`` (``cuda`` unless
        the caller asks for ``"cpu"``) as JAX ``Fp8Tensor.quantize`` does it:
        per tensor ``s = max|w| / 448`` (1 where that is 0), blockwise each
        ``bn x bk`` block's ``max|block| / 448`` (1 for an all-zero block),
        codes ``e4m3(w / s)``, bit for bit."""
        dev = resolve_device(device)
        w = w.to(device=dev, dtype=torch.float32)
        n, k = w.shape
        e4m3_max = torch.tensor(E4M3_MAX, device=dev)
        if block_shape is None:
            s = w.abs().amax() / e4m3_max
            s = torch.where(s == 0, torch.ones_like(s), s)
            return cls.from_nk((w / s).to(torch.float8_e4m3fn), s)
        bn, bk = block_shape
        nb, kb = -(-n // bn), -(-k // bk)
        wp = torch.zeros((nb * bn, kb * bk), dtype=torch.float32, device=dev)
        wp[:n, :k] = w
        blocks = wp.reshape(nb, bn, kb, bk)
        amax = blocks.abs().amax(dim=(1, 3))
        s = torch.where(amax > 0, amax / e4m3_max, torch.ones_like(amax))
        scaled = (blocks / s[:, None, :, None]).reshape(nb * bn, kb * bk)[:n, :k]
        return cls.from_nk(scaled.to(torch.float8_e4m3fn), s, (bn, bk))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """``[N, K]``: each code times its scale in f32, then cast (JAX
        ``Fp8Tensor.dequantize``)."""
        k, n = self.data.shape
        plane = self.plane.repeat_interleave(self.group_size, dim=0)[:k]  # [K, N]
        return (self.data.to(torch.float32) * plane).T.to(dtype)

    def to(self, device) -> "Fp8Tensor":
        return Fp8Tensor(self.data.to(device), self.scale.to(device), self.block_shape)


def fp8_matmul(x: torch.Tensor, w: Fp8Tensor, *, out_dtype: Optional[torch.dtype] = None,
               plain: bool = False) -> torch.Tensor:
    """``x [..., K] @ w.T`` in ``out_dtype`` (``x``'s by default): the W8
    kernel's e4m3 form on a CUDA tensor (or it raises), the plain version on
    a CPU tensor or with ``plain=True`` (JAX ``fp8_matmul``)."""
    from ..ops.quant_matmul import quant_matmul

    return quant_matmul(x, w, out_dtype=out_dtype, plain=plain)
