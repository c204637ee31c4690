"""MXFP4 (OCP microscaling FP4) decoding, the form gpt-oss checkpoints ship
their expert banks in (counterpart of ``mistralrs_tpu/quant/mxfp4.py:33-80``).

A tensor ``<name>`` is stored as ``<name>_blocks`` ``[..., n_blocks, 16]``
uint8 (two FP4 E2M1 codes a byte, the low nibble first: magnitudes 0, 0.5,
1, 1.5, 2, 3, 4, 6 and a sign bit) and ``<name>_scales`` ``[..., n_blocks]``
uint8 (one E8M0 power of two a 32-value block, biased by 127), for a
logical ``[..., n_blocks * 32]`` weight.

Each value is an FP4 value (at most two significant bits) times a power of
two, so it is exact in bf16 wherever it is a normal or subnormal bf16
number: the decode runs on the target device, one leading slice at a time
(one expert of a bank), straight to the requested dtype, and never holds a
whole bank in f32 (the JAX decode builds whole-bank float32 numpy arrays,
about 76 GB on the host for gpt-oss-120b's banks).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
              -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
BLOCK = 32


def dequantize_mxfp4(blocks: torch.Tensor, scales: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """``blocks`` ``[..., n_blocks, 16]`` uint8 and ``scales`` ``[...,
    n_blocks]`` uint8 (on one device) → ``dtype`` ``[..., n_blocks * 32]``
    on that device, value ``2j`` from the low nibble of byte ``j`` and
    ``2j + 1`` from its high nibble."""
    lut = torch.tensor(FP4_VALUES, dtype=torch.float32, device=blocks.device)
    vals = torch.stack([lut[(blocks & 0xF).long()], lut[(blocks >> 4).long()]], dim=-1)
    # 2^(s - 127) as f32 bits: exponent field s, or the subnormal 2^-127 for s = 0
    s = scales.to(torch.int32)
    bits = torch.where(s > 0, s << 23, torch.full_like(s, 1 << 22))
    out = vals.reshape(*blocks.shape[:-1], BLOCK) * bits.view(torch.float32)[..., None]
    return out.reshape(*blocks.shape[:-2], blocks.shape[-2] * BLOCK).to(dtype)


def decode_mxfp4_param(sd: Mapping[str, torch.Tensor], stem: str, device,
                       dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """``<stem>_blocks`` / ``<stem>_scales`` of a state dict decoded on
    ``device`` one leading slice at a time → ``dtype`` ``[..., K]`` in the
    blocks' own layout; None when the state dict does not hold them."""
    blocks, scales = sd.get(stem + "_blocks"), sd.get(stem + "_scales")
    if blocks is None or scales is None:
        return None
    if blocks.dim() < 3:
        return dequantize_mxfp4(blocks.to(device), scales.to(device), dtype)
    out = torch.empty((*blocks.shape[:-2], blocks.shape[-2] * BLOCK), dtype=dtype,
                      device=device)
    for i in range(blocks.shape[0]):
        out[i] = dequantize_mxfp4(blocks[i].to(device), scales[i].to(device), dtype)
    return out
