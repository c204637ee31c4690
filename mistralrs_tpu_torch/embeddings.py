"""Sequence embeddings from the decoder's final hidden states (counterpart
of ``mistralrs_tpu/embeddings.py``: ``_embed_batch`` :23-45 and ``embed``
:48-75): the llama-family stack as an encoder (qwen3-embedding,
gemma-embedding).

Pooling: ``last`` (each sequence's last valid token, the causal LM
convention), ``mean`` (over the valid tokens) or ``cls`` (the first
token), optionally L2-normalised. The batch runs from position 0 through a
fresh bf16 contiguous cache, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, weights_device
from .kv.contiguous import KVCache
from .models.config import ModelConfig
from .models.llama import forward

POOLINGS = ("last", "mean", "cls")


def _embed_batch(weights: dict, cfg: ModelConfig, ids: torch.Tensor, lengths: torch.Tensor,
                 pooling: str, normalize: bool, plain: bool) -> torch.Tensor:
    b, t = ids.shape
    positions = torch.arange(t, device=ids.device)[None].expand(b, t)
    cache = KVCache.create(cfg, b, t, dtype=torch.bfloat16, device=ids.device)
    hidden, _ = forward(weights, cfg, ids, positions, cache, [0] * b, return_hidden=True,
                        plain=plain)  # [B, T, H] f32
    mask = (torch.arange(t, device=ids.device)[None] < lengths[:, None]).to(torch.float32)
    if pooling == "mean":
        pooled = (hidden * mask[..., None]).sum(dim=1) / torch.clamp(
            mask.sum(dim=1, keepdim=True), min=1.0)
    elif pooling == "cls":
        pooled = hidden[:, 0]
    else:  # the last valid token (an index past the batch's width takes its last)
        idx = torch.clamp(lengths - 1, 0, t - 1)
        pooled = hidden[torch.arange(b, device=ids.device), idx]
    if normalize:
        pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                      min=1e-12)
    return pooled


def embed(
    weights: dict,
    cfg: ModelConfig,
    token_batches: Sequence[Sequence[int]],
    *,
    pooling: str = "last",
    normalize: bool = True,
    max_len: Optional[int] = None,
    plain: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """Embed a batch of token sequences → ``[B, H]`` float32 (each cut to
    ``max_len``, else padded to the longest). Runs on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``), where the weights must lie."""
    if pooling not in POOLINGS:
        raise ValueError(f"pooling {pooling!r}: one of {POOLINGS}")
    dev = weights_device(weights, device)
    if not token_batches:
        return np.zeros((0, cfg.hidden_size), np.float32)
    lengths = np.asarray([len(x) for x in token_batches], np.int64)
    t = int(max_len or max(1, lengths.max()))
    ids = np.zeros((len(token_batches), t), np.int64)
    for i, toks in enumerate(token_batches):
        row = list(toks)[:t]
        ids[i, :len(row)] = row
    out = _embed_batch(weights, cfg, torch.from_numpy(ids).to(dev),
                       torch.from_numpy(lengths).to(dev), pooling, normalize, plain)
    return out.cpu().numpy()
