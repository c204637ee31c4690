"""Single-sequence generation over the contiguous KV cache (counterpart of
``mistralrs_tpu/generate.py``: ``generate`` :44-100 with its
``_prefill_step`` and ``_decode_step`` :22-41). The engine
(``engine/engine.py``) serves batches over the paged cache; this is the
simple library entry point.

The prompt runs as one prefill from position 0, then one token a step
(greedy, or drawn at ``temperature`` from a ``torch.Generator`` on the
device seeded with ``seed``), each step an eager ``forward``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ._device import DeviceLike, weights_device
from .kv.contiguous import HybridKVCache, KVCache, RotatingKVCache
from .models.config import ModelConfig
from .models.llama import forward

CACHE_TYPES = ("normal", "rotating", "hybrid")


def _make_cache(cfg: ModelConfig, cache_type: str, batch: int, capacity: int, dtype, device):
    """``normal``: :class:`KVCache` of ``capacity``; ``rotating``: the
    window's ring (uniformly sliding models); ``hybrid``: full pools of
    ``capacity`` and one ring (a per-layer window mix)."""
    if cache_type == "rotating":
        return RotatingKVCache.create(cfg, batch, dtype=dtype, device=device)
    if cache_type == "hybrid":
        return HybridKVCache.create(cfg, batch, capacity, dtype=dtype, device=device)
    if cache_type == "normal":
        return KVCache.create(cfg, batch, capacity, dtype=dtype, device=device)
    raise ValueError(f"cache_type {cache_type!r}: one of {CACHE_TYPES}")


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``[B, V]`` f32 logits → ``[B]`` token ids: the argmax at temperature
    0, else a draw from ``softmax(logits / temperature)`` with
    ``generator``."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(
    weights: dict,
    cfg: ModelConfig,
    prompt_ids: Sequence[int],
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    seed: int = 0,
    stop_tokens: Optional[set[int]] = None,
    kv_capacity: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    cache_type: str = "normal",
    device: DeviceLike = None,
) -> list[int]:
    """Greedy or temperature sampling for one sequence; returns the new
    tokens (up to the first stop token, ``cfg.eos_token_ids`` by default).
    The cache holds ``kv_capacity`` positions, by default ``min(
    max_position_embeddings, prompt + max_new_tokens)``; a sequence that
    outgrows it raises. Runs on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``), where the weights must lie."""
    dev = weights_device(weights, device)
    ids = torch.as_tensor(list(prompt_ids), dtype=torch.long, device=dev)[None]
    t0 = ids.shape[1]
    capacity = kv_capacity or min(cfg.max_position_embeddings, t0 + max_new_tokens)
    cache = _make_cache(cfg, cache_type, 1, capacity, compute_dtype, dev)
    stops = stop_tokens if stop_tokens is not None else set(cfg.eos_token_ids)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    positions = torch.arange(t0, device=dev)[None]
    logits, cache = forward(weights, cfg, ids, positions, cache, [0],
                            logits_last_only=True, compute_dtype=compute_dtype)
    out: list[int] = []
    pos = t0
    for step in range(max_new_tokens):
        tok = sample(logits[:, -1], temperature, gen)
        tok_i = int(tok[0])
        if tok_i in stops:
            break
        out.append(tok_i)
        if step == max_new_tokens - 1:  # JAX runs one more step, whose logits go unused
            break
        logits, cache = forward(weights, cfg, tok[:, None], torch.full((1, 1), pos, device=dev),
                                cache, [pos], logits_last_only=True,
                                compute_dtype=compute_dtype)
        pos += 1
    return out
