"""Perplexity over non-overlapping windows (counterpart of
``mistralrs_tpu/perplexity.py``: ``_window_nll`` :28-47 and
``compute_perplexity`` :50-116), the quality check of a quantized model,
llama.cpp's protocol.

The token stream is cut into windows of ``window`` tokens; each is scored
from a fresh context, and the negative log-likelihood is summed over the
positions ``p >= first`` (the burn-in ``min(512, window // 2)``, clamped to
``[1, window - 1]``), position ``p`` scored by the logits at ``p - 1``.
Windows run ``batch_size`` at a time through ``models/llama.py::forward``
over one contiguous cache; the last batch is padded with zero windows whose
scores are dropped. PPL = exp(mean NLL).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, weights_device
from .kv.contiguous import KVCache
from .models.config import ModelConfig
from .models.llama import forward


def _window_nll(weights: dict, cfg: ModelConfig, cache: KVCache, ids: torch.Tensor, first: int,
                compute_dtype, plain: bool):
    """``ids [B, W]`` → ``(nll_sum [B], count [B])`` over positions
    ``>= first``."""
    b, w = ids.shape
    positions = torch.arange(w, device=ids.device)[None].expand(b, w)
    logits, _ = forward(weights, cfg, ids, positions, cache, [0] * b,
                        compute_dtype=compute_dtype, plain=plain)  # [B, W, V] f32
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tok_nll = -torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
    mask = (torch.arange(1, w, device=ids.device)[None] >= first).to(torch.float32)
    return (tok_nll * mask).sum(dim=1), mask.sum(dim=1).expand(b)


def compute_perplexity(
    weights: dict,
    cfg: ModelConfig,
    token_ids: Sequence[int],
    *,
    window: int = 512,
    batch_size: int = 4,
    compute_dtype=torch.bfloat16,
    burn_in: Optional[int] = None,
    progress: bool = False,
    plain: bool = False,
    device: DeviceLike = None,
) -> dict:
    """Perplexity of ``token_ids`` under the model: ``{"ppl", "nll" (mean
    nats a scored token), "tokens_scored", "windows"}``. Runs on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``), where the weights must
    lie."""
    dev = weights_device(weights, device)
    ids = np.asarray(token_ids, np.int64)
    if ids.ndim != 1:
        raise ValueError("token_ids must be a flat sequence")
    window = min(window, cfg.max_position_embeddings)
    n_win = len(ids) // window
    if n_win == 0:
        raise ValueError(f"need at least {window} tokens for one window, got {len(ids)}")
    first = burn_in if burn_in is not None else min(512, window // 2)
    first = max(1, min(first, window - 1))
    cache = KVCache.create(cfg, batch_size, window, dtype=compute_dtype, device=dev)
    total_nll = 0.0
    total_cnt = 0.0
    wins = ids[: n_win * window].reshape(n_win, window)
    for i in range(0, n_win, batch_size):
        batch = wins[i:i + batch_size]
        real = batch.shape[0]
        if real < batch_size:  # pad to the batch's shape, drop the padding's scores
            batch = np.concatenate([batch, np.zeros((batch_size - real, window), np.int64)])
        nll, cnt = _window_nll(weights, cfg, cache, torch.from_numpy(batch).to(dev), first,
                               compute_dtype, plain)
        total_nll += float(nll[:real].sum())
        total_cnt += float(cnt[:real].sum())
        if progress:
            done = min(i + batch_size, n_win)
            print(f"[{done}/{n_win}] ppl so far: "
                  f"{math.exp(total_nll / max(total_cnt, 1)):.4f}", flush=True)
    return {
        "ppl": math.exp(total_nll / total_cnt),
        "nll": total_nll / total_cnt,
        "tokens_scored": int(total_cnt),
        "windows": n_win,
    }
