"""Device-side paged KV cache pools and their write/gather ops (counterpart
of ``mistralrs_tpu/kv/paged.py``).

Layout: one head-major pool per K and V, ``[L, n_kv, (num_blocks + 1) *
block_size, head_dim]`` bf16, so one (head, block) stripe is contiguous and a
slot is ``block * block_size + row``. The extra block at the end is the trash
block: writes with slot < 0 land there (``write_kv``) or are dropped (the
kernels), and no block table ever points at it.

Quantized pools (``kv_quant="int8"`` or ``"fp8"``, e4m3) hold 1-byte codes
with one absmax scale per (layer, head, slot) in ``k_scale``/``v_scale``
``[L, n_kv, S_total]`` bf16, head-major like the pools (one 64-position
tile of one head has its 64 scales in 128 contiguous bytes; the JAX package
packs them slot-major into one ``[L, S_total, SW]`` plane for the TPU's lane
quantum instead). A row ``x`` is quantized as the JAX package's ``write_kv``
does (:func:`quantize_rows`): in f32, ``s = max|x| / cap`` (cap 127 for
int8, 448 for e4m3), codes ``x / max(s, 1e-10)`` rounded half to even and
clipped to ±127 (int8) or cast to e4m3 with round-to-nearest-even, and the
scale stored as bf16; a row reads back as ``code × float(bf16(s))``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import torch

from .._device import DeviceLike, resolve_device

if TYPE_CHECKING:  # the model package imports this module
    from ..models.config import ModelConfig


#: the pool dtype of each ``kv_quant`` name and its largest code
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
CODE_CAPS = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def is_quantized(pool: torch.Tensor) -> bool:
    """A pool of 1-byte codes (int8 or fp8-e4m3)."""
    return pool.dtype in CODE_CAPS


@dataclass
class PagedKVCache:
    """k/v pools: [L, n_kv, S_total(slots), head_dim]; updated in place.
    Quantized pools carry their scales ``k_scale``/``v_scale`` [L, n_kv,
    S_total] bf16 (None for bf16 pools)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        num_blocks: int,
        block_size: int,
        dtype=torch.bfloat16,
        kv_quant: Optional[str] = None,
        device: DeviceLike = None,
    ) -> "PagedKVCache":
        """Zeroed pools on ``device`` (``cuda`` unless the caller asks for
        ``"cpu"``): ``dtype`` pools, or with ``kv_quant`` (``"int8"`` or
        ``"fp8"``) 1-byte pools and their bf16 scales."""
        device = resolve_device(device)
        # +1 trash block: dropped writes (slot −1) go there, never to a live slot
        slots = (num_blocks + 1) * block_size
        shape = (cfg.num_layers, cfg.num_kv_heads, slots, cfg.head_dim)
        if kv_quant is None:
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        if kv_quant not in CODE_DTYPES:
            raise ValueError(f"kv_quant must be one of {sorted(CODE_DTYPES)}, got {kv_quant!r}")
        code = CODE_DTYPES[kv_quant]
        return cls(*(torch.zeros(shape, dtype=code, device=device) for _ in range(2)),
                   *(torch.zeros(shape[:3], dtype=torch.bfloat16, device=device)
                     for _ in range(2)))


def quantize_rows(x: torch.Tensor, code_dtype: torch.dtype):
    """Absmax quantization of rows over the last axis (the JAX package's
    ``write_kv`` and its kernels' ``qenc``) → ``(codes, s)``: ``s`` the f32
    scale before its rounding to bf16 for storage. The division is a true
    f32 division, as in the JAX package (both operands tensors: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, CODE_CAPS[code_dtype])
    y = xf / torch.clamp_min(s, 1e-10)[..., None]
    if code_dtype == torch.int8:
        return torch.round(y).clamp(-127, 127).to(torch.int8), s
    return y.to(code_dtype), s


def write_kv(
    cache_k: torch.Tensor,  # [n_kv, S_total, hd] (one layer), updated in place
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # [T, n_kv, hd]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [T] int physical slot ids; negative → trash
    k_scale: Optional[torch.Tensor] = None,  # [n_kv, S_total] bf16 (quantized pools)
    v_scale: Optional[torch.Tensor] = None,
) -> None:
    """reshape_and_cache: scatter new KV rows into the pool. Rows with
    slot < 0 land in the trash block's last slot. Quantized pools take the
    rows' codes (:func:`quantize_rows`, from the rows' own values: f32 rows
    are not rounded to bf16 first) and their scales."""
    trash = cache_k.shape[1] - 1
    safe = torch.where(slots < 0, torch.full_like(slots, trash), slots).to(
        device=cache_k.device, dtype=torch.long)
    for pool, scale, new in ((cache_k, k_scale, k_new), (cache_v, v_scale, v_new)):
        new = new.transpose(0, 1)  # [n_kv, T, hd]
        if scale is None:
            pool[:, safe] = new.to(pool.dtype)
        else:
            codes, s = quantize_rows(new, pool.dtype)
            pool[:, safe] = codes
            scale[:, safe] = s.to(scale.dtype)


def gather_kv(
    cache_k: torch.Tensor,  # [n_kv, S_total, hd]
    cache_v: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int (−1 padding allowed)
    block_size: int,
    dtype=torch.bfloat16,
    k_scale: Optional[torch.Tensor] = None,  # [n_kv, S_total] bf16 (quantized pools)
    v_scale: Optional[torch.Tensor] = None,
):
    """Per-sequence KV [B, max_blocks * block_size, n_kv, hd] gathered from
    the pool (validity masked downstream by kv_len); quantized pools read
    back as ``code × scale`` in f32, then ``dtype``."""
    bt = block_table.clamp_min(0).to(device=cache_k.device, dtype=torch.long)
    slots = (bt[:, :, None] * block_size
             + torch.arange(block_size, device=bt.device)).reshape(bt.shape[0], -1)
    out = []
    for pool, scale in ((cache_k, k_scale), (cache_v, v_scale)):
        x = pool[:, slots]  # [n_kv, B, S, hd]
        if scale is not None:
            x = x.to(torch.float32) * scale[:, slots].to(torch.float32)[..., None]
        out.append(x.permute(1, 2, 0, 3).to(dtype))
    return tuple(out)


def calculate_cache_config(
    cfg: ModelConfig,
    *,
    block_size: int = 64,
    max_model_len: int,
    max_batch: int,
    kv_quant: bool = False,
    dtype=torch.bfloat16,
    utilization: float = 0.90,
    weight_bytes: int | None = None,
    mem_bytes: int | None = None,
    device: torch.device | str = "cuda",
    bytes_per_token: int | None = None,
) -> int:
    """Memory-utilization-driven KV pool sizing (the analog of the reference's
    ``calculate_cache_config``): fill ``utilization`` of the device's free
    memory (``torch.cuda.mem_get_info``) with KV blocks, clamped to [two
    blocks per sequence … full length for ``max_batch`` sequences].
    ``mem_bytes`` overrides the free-memory query (CPU callers pass it);
    ``bytes_per_token`` overrides the llama pools' K + V bytes per token
    (an arch adapter's own cache, e.g. DeepSeek's latent pool). With
    ``kv_quant`` a token takes ``2·L·n_kv·(head_dim + 2)`` bytes: 1-byte
    codes and one bf16 scale per (layer, head) for K and for V (the JAX
    package's packed scale plane adds ``L·SW·2`` per slot instead)."""
    if bytes_per_token is None:
        row = cfg.head_dim + 2 if kv_quant else (
            cfg.head_dim * torch.empty((), dtype=dtype).element_size())
        bytes_per_token = 2 * cfg.num_layers * cfg.num_kv_heads * row
    bytes_per_block = bytes_per_token * block_size
    if mem_bytes is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError("calculate_cache_config needs mem_bytes off CUDA")
        free, _total = torch.cuda.mem_get_info(dev)
        if weight_bytes is not None:
            # weights not yet resident: subtract their projected size
            free -= max(weight_bytes - torch.cuda.memory_allocated(dev), 0)
    else:
        free = mem_bytes - (weight_bytes or 0)
    budget = int(free * utilization)
    # create() allocates num_blocks + 1 (the trash block)
    num_blocks = max(budget // bytes_per_block - 1, 1)
    min_blocks = max_batch * 2
    max_useful = -(-max_model_len // block_size) * max_batch
    return int(min(max(num_blocks, min_blocks), max_useful))
