"""bitsandbytes 4-bit checkpoints (NF4 / FP4), decoded on the device
(counterpart of ``mistralrs_tpu/quant/bnb.py``).

A 4-bit linear of a bitsandbytes checkpoint (HF ``save_pretrained`` of a
4-bit model, ``quantization_config.quant_method == "bitsandbytes"``) stores

- ``<name>.weight``: uint8 ``[n*k/2, 1]``, two codes a byte, the FIRST
  element in the HIGH nibble;
- ``<name>.weight.absmax``: one scale per ``blocksize`` (64) elements, f32,
  or uint8 indices when the scales are double-quantized;
- ``<name>.weight.quant_map``: the 16-entry code table (NF4 or FP4);
- double quantization: ``nested_absmax`` f32 (one per 256 scales) and
  ``nested_quant_map`` [256] f32, and
  ``absmax[i] = nested_quant_map[idx[i]] * nested_absmax[i // 256] + offset``;
- ``<name>.weight.quant_state.bitsandbytes__nf4`` (or ``__fp4``): uint8 bytes
  of a JSON object with the ``shape``, ``blocksize`` and the nested offset.

The code table is not linear, so a weight decodes to a dense tensor
(:func:`decode_bnb_param`) on the device its bytes were copied to; the
loader then casts it (bf16) or quantizes it in situ for the W4/W8 kernels.

The port reads the nested scales as bitsandbytes writes them, block ``i //
256`` for scale ``i``, and the offset under ``nested_offset`` (``offset``
where that is absent). The JAX package indexes the nested scales by the
scale's code value (``idx // 256``: always block 0) and reads only
``offset``; the two agree on a tensor of at most 256 scales with its
offset under ``offset`` (ROADMAP, Queue 3).
"""

from __future__ import annotations

import json
import math
from typing import Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

# the published NF4 quantiles (QLoRA, Dettmers et al. 2023)
NF4_CODE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0],
    dtype=np.float32,
)
# bnb FP4: e2m1 magnitudes with bnb's sign-in-high-bit ordering
FP4_CODE = np.array(
    [0.0, 0.0052083334, 0.6666667, 1.0, 0.3333333, 0.5, 0.16666667, 0.25,
     -0.0, -0.0052083334, -0.6666667, -1.0, -0.3333333, -0.5, -0.16666667,
     -0.25],
    dtype=np.float32,
)

BLOCKSIZE = 64
NESTED_BLOCKSIZE = 256
_STATE_SUFFIXES = (".quant_state.bitsandbytes__nf4", ".quant_state.bitsandbytes__fp4")


def _t(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def dequantize_4bit(packed, absmax, quant_map, shape: tuple[int, ...],
                    blocksize: int = BLOCKSIZE, nested_absmax=None, nested_quant_map=None,
                    absmax_offset: float = 0.0, device: DeviceLike = None) -> torch.Tensor:
    """Decode packed 4-bit codes to f32 of ``shape`` on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``; each input is copied there
    first): ``quant_map[code] * absmax[element // blocksize]``, the absmax
    first decoded from its nested quantization where given."""
    dev = resolve_device(device)
    n = math.prod(shape)
    p = _t(packed, dev, torch.uint8).reshape(-1)
    codes = torch.stack([p >> 4, p & 15], dim=1).reshape(-1)[:n].long()
    am = _t(absmax, dev)
    if nested_absmax is not None:  # double quantization of the block scales
        nm = _t(nested_quant_map, dev, torch.float32)
        na = _t(nested_absmax, dev, torch.float32).reshape(-1)
        idx = am.reshape(-1).long()
        block = torch.arange(idx.numel(), device=dev) // NESTED_BLOCKSIZE
        block = block.clamp(max=na.numel() - 1)
        am = nm[idx] * na[block] + torch.tensor(absmax_offset, dtype=torch.float32, device=dev)
    am = am.to(torch.float32).reshape(-1)
    vals = _t(quant_map, dev, torch.float32)[codes]
    return (vals * am.repeat_interleave(blocksize)[:n]).reshape(shape)


def _nearest(scaled: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The index of the nearest ``table`` entry (the first among equals) to
    each value of ``scaled``, as uint8, in chunks of about 2^24 distances."""
    flat = scaled.reshape(-1)
    step = max(1, (1 << 24) // table.numel())
    return torch.cat([(flat[i:i + step, None] - table).abs().argmin(dim=-1).to(torch.uint8)
                      for i in range(0, flat.numel(), step)])


def quantize_4bit(w: torch.Tensor, quant_map=NF4_CODE,
                  blocksize: int = BLOCKSIZE) -> tuple[torch.Tensor, torch.Tensor]:
    """float ``w`` → ``(packed uint8 [ceil(n/2), 1], absmax f32 [n / blocksize])``
    on ``w``'s device: each block's codes the nearest table entries of
    ``w / max|block|`` (JAX ``quantize_4bit``, for tests and the smoke run;
    no double quantization)."""
    flat = w.to(torch.float32).reshape(-1)
    n = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, -n % blocksize))
    g = flat.reshape(-1, blocksize)
    absmax = g.abs().amax(dim=1)
    scaled = g / torch.where(absmax > 0, absmax, torch.ones_like(absmax))[:, None]
    codes = _nearest(scaled, _t(quant_map, w.device, torch.float32))[:n]
    codes = torch.nn.functional.pad(codes, (0, n % 2))
    return ((codes[0::2] << 4) | codes[1::2]).reshape(-1, 1), absmax


def double_quantize(absmax: torch.Tensor, nested_quant_map, offset: Optional[float] = None):
    """The block scales double-quantized as bitsandbytes stores them:
    ``(idx uint8, nested_absmax f32 [ceil(n / 256)], offset)``, each index
    the nearest entry of ``nested_quant_map`` to ``(absmax - offset) /
    nested_absmax`` of its 256-scale block (offset: the scales' mean where
    not given)."""
    am = absmax.to(torch.float32).reshape(-1)
    off = float(am.mean()) if offset is None else float(offset)
    n = am.numel()
    centred = torch.nn.functional.pad(am - off, (0, -n % NESTED_BLOCKSIZE))
    blocks = centred.reshape(-1, NESTED_BLOCKSIZE)
    na = blocks.abs().amax(dim=1)
    scaled = blocks / torch.where(na > 0, na, torch.ones_like(na))[:, None]
    idx = _nearest(scaled, _t(nested_quant_map, am.device, torch.float32))[:n]
    return idx, na, off


def decode_bnb_param(sd: Mapping[str, torch.Tensor], stem: str,
                     device: DeviceLike = None) -> Optional[torch.Tensor]:
    """``stem``'s 4-bit weight decoded from its bitsandbytes side tensors,
    f32 on ``device``; None where ``stem`` is not a 4-bit bitsandbytes
    weight (JAX ``decode_bnb_param``)."""
    packed = sd.get(stem)
    state = next((sd[stem + s] for s in _STATE_SUFFIXES if stem + s in sd), None)
    if packed is None or state is None:
        return None
    raw = state.cpu().numpy() if isinstance(state, torch.Tensor) else np.asarray(state)
    meta = json.loads(bytes(raw.astype(np.uint8).reshape(-1)).decode("utf-8"))
    return dequantize_4bit(
        packed, sd[stem + ".absmax"], sd[stem + ".quant_map"], tuple(meta["shape"]),
        blocksize=int(meta.get("blocksize", BLOCKSIZE)),
        nested_absmax=sd.get(stem + ".nested_absmax"),
        nested_quant_map=sd.get(stem + ".nested_quant_map"),
        absmax_offset=float(meta.get("nested_offset", meta.get("offset", 0.0))),
        device=device,
    )


def side_tensor_names(stem: str) -> tuple[str, ...]:
    """The side tensors a 4-bit bitsandbytes weight ``stem`` may carry."""
    return tuple(stem + s for s in (".absmax", ".quant_map", ".nested_absmax",
                                    ".nested_quant_map", *_STATE_SUFFIXES))
