"""GPTQ and AWQ checkpoint decoding to planar :class:`QTensor`\\ s
(counterpart of ``mistralrs_tpu/quant/gptq_awq.py``).

Both formats decode into the planar ``w = scale * q + bias`` of the GGUF
k-quants, so the W4 and W8 dequant-matmul kernels serve them (at groups of
64 and 128, and per-column scales: g = K).

Format facts (AutoGPTQ / AutoAWQ conventions):

* GPTQ: ``qweight`` int32 ``[K / (32 / bits), N]``, ``32 / bits`` codes a
  word along K (code ``i`` of a word in bits ``i * bits ..``); ``qzeros``
  int32 ``[K / g, N / (32 / bits)]``, the same packing along N; ``scales``
  f16 ``[K / g, N]``; ``g_idx`` ``[K]`` optional (act-order). Dequant:
  ``w[k, n] = s[g, n] * (q[k, n] - (z[g, n] + zero_offset))`` with
  ``zero_offset`` 1 for v1 checkpoints and 0 for ``gptq_v2``.
* AWQ (GEMM packing, 4-bit): ``qweight`` int32 ``[K, N / 8]``, eight codes a
  word along N in the interleaved order (0, 2, 4, 6, 1, 3, 5, 7); ``qzeros``
  int32 ``[K / g, N / 8]`` packed alike; ``scales`` f16 ``[K / g, N]``.
  Dequant: ``w = s * (q - z)``.

The planes equal the JAX package's bit for bit: f16 scales widened to f32,
``bias = -s * (z + zero_offset)`` in f32. The decode runs in torch on the
caller's device (the words are read by shifts and masks: torch's ``>>`` on
int32 is arithmetic, so every shift is masked, and a word with bit 31 set
decodes as the JAX package's ``uint32`` view does). 4-bit codes are
split-half packed where ``(K / 2) % g == 0`` (the W4 kernel), else kept one
byte a code (unsigned with a bias plane: the W8 kernel), as
``QTensor.from_planar`` packs them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .qtensor import QTensor

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # logical column of each code of a packed word
# code of the packed word at each logical column: the inverse permutation
_AWQ_INV = tuple(sorted(range(8), key=lambda i: AWQ_ORDER[i]))


def _nibbles(words: torch.Tensor, bits: int) -> list[torch.Tensor]:
    """The ``32 / bits`` codes of int32 ``words``, code ``i`` from bits ``i *
    bits ..``, each as uint8 of the words' shape (masked after the shift:
    the shift is arithmetic)."""
    mask = (1 << bits) - 1
    w = words.to(torch.int32)
    return [((w >> (i * bits)) & mask).to(torch.uint8) for i in range(32 // bits)]


def unpack_gptq_qweight(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """``[K / (32 / bits), N]`` int32 → ``[K, N]`` uint8 codes (packed along K)."""
    kq, n = qweight.shape
    return torch.stack(_nibbles(qweight, bits), dim=1).reshape(kq * (32 // bits), n)


def unpack_cols(packed: torch.Tensor, bits: int, awq: bool) -> torch.Tensor:
    """``[R, N / (32 / bits)]`` int32 → ``[R, N]`` uint8 codes (packed along
    N; AWQ's 4-bit words in its interleaved order)."""
    r, nq = packed.shape
    codes = _nibbles(packed, bits)
    if awq and bits == 4:
        codes = [codes[i] for i in _AWQ_INV]
    return torch.stack(codes, dim=-1).reshape(r, nq * (32 // bits))


def _is_trivial_g_idx(g_idx: torch.Tensor, group: int) -> bool:
    k = g_idx.shape[0]
    want = torch.arange(k, device=g_idx.device) // group
    return bool(torch.equal(g_idx.to(torch.int64), want))


def _planar(q: torch.Tensor, s: torch.Tensor, zero: torch.Tensor, bits: int) -> QTensor:
    """K-major codes ``[K, N]``, f32 scales and zeros ``[G, N]`` → the
    planar QTensor ``[N, K]`` (``bias = -s * zero``), 4-bit codes packed as
    ``QTensor.from_planar`` packs them."""
    k = q.shape[0]
    if k % s.shape[0] != 0:
        raise ValueError(f"K={k} is not a whole number of {s.shape[0]} groups")
    group = k // s.shape[0]
    bias = -s * zero
    pack = bits <= 4 and (k // 2) % group == 0
    data = (q[:k // 2] | (q[k // 2:] << 4)) if pack else q
    return QTensor(data=data.contiguous(), scale=s.contiguous(), bias=bias.contiguous(),
                   group_size=group, packed=pack, code_bits=bits)


def gptq_to_qtensor(
    qweight: torch.Tensor,
    qzeros: torch.Tensor,
    scales: torch.Tensor,
    g_idx: Optional[torch.Tensor] = None,
    bits: int = 4,
    zero_offset: int = 1,
) -> QTensor:
    """A GPTQ layer (tensors as stored, K-major, on one device) → a QTensor
    ``[N, K]`` on that device. A non-trivial ``g_idx`` (act-order) raises
    ``NotImplementedError``, as in the JAX package."""
    if bits not in (4, 8):
        raise NotImplementedError(f"GPTQ at {bits} bits: only 4 and 8 are ported")
    q = unpack_gptq_qweight(qweight, bits)  # [K, N]
    z = unpack_cols(qzeros, bits, awq=False)  # [G, N]
    s = scales.to(torch.float32)
    group = q.shape[0] // s.shape[0]
    if g_idx is not None and not _is_trivial_g_idx(g_idx, group):
        raise NotImplementedError(
            "GPTQ act-order (non-trivial g_idx) is not ported; the JAX package refuses it too")
    return _planar(q, s, z.to(torch.float32) + float(zero_offset), bits)


def awq_to_qtensor(
    qweight: torch.Tensor,
    qzeros: torch.Tensor,
    scales: torch.Tensor,
    bits: int = 4,
) -> QTensor:
    """An AWQ layer (GEMM packing: K-major, N-packed int32, on one device) →
    a QTensor ``[N, K]`` on that device; bits other than 4 raise."""
    if bits != 4:
        raise NotImplementedError("AWQ is 4-bit")
    q = unpack_cols(qweight, bits, awq=True)  # [K, N]
    z = unpack_cols(qzeros, bits, awq=True)  # [G, N]
    return _planar(q, scales.to(torch.float32), z.to(torch.float32), bits)


def dequant_gptq_reference(qweight, qzeros, scales, bits: int = 4,
                           zero_offset: int = 1) -> torch.Tensor:
    """Straight-line GPTQ dequant (for tests): ``[K, N]`` f32."""
    q = unpack_gptq_qweight(qweight, bits).to(torch.float32)
    z = unpack_cols(qzeros, bits, awq=False).to(torch.float32)
    s = scales.to(torch.float32)
    gi = torch.arange(q.shape[0], device=q.device) // (q.shape[0] // s.shape[0])
    return s[gi] * (q - (z[gi] + zero_offset))


def dequant_awq_reference(qweight, qzeros, scales) -> torch.Tensor:
    """Straight-line AWQ dequant (for tests): ``[K, N]`` f32."""
    q = unpack_cols(qweight, 4, awq=True).to(torch.float32)
    z = unpack_cols(qzeros, 4, awq=True).to(torch.float32)
    s = scales.to(torch.float32)
    gi = torch.arange(q.shape[0], device=q.device) // (q.shape[0] // s.shape[0])
    return s[gi] * (q - z[gi])
