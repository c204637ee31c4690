"""Causal grouped-query attention over a contiguous KV buffer (counterpart
of ``mistralrs_tpu/ops/attention.py::sdpa``, :27-89).

The JAX package computes this with XLA, not Pallas, so the port keeps it a
plain PyTorch function: f32 einsums, masks as ``NEG_INF`` logits and an f32
softmax, as JAX does. It is neither ``F.scaled_dot_product_attention`` nor a
``-inf`` mask: a query row that sees no key gets the mean of V here (a
softmax over equal ``NEG_INF`` logits), as in JAX, where those give NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def sdpa(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k: torch.Tensor,  # [B, S, n_kv, hd]
    v: torch.Tensor,  # [B, S, n_kv, hd]
    *,
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    kv_len: Optional[torch.Tensor] = None,  # [B] valid entries (k[:, :kv_len])
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,  # <= 0 or None: no window
    sinks: Optional[torch.Tensor] = None,  # [n_q] attention-sink logits
    kv_positions: Optional[torch.Tensor] = None,  # [B, S] slot positions, -1 invalid
) -> torch.Tensor:
    """KV slot ``s`` at position ``ps`` (``s`` itself, or ``kv_positions``)
    is visible to the query at position ``p`` iff ``ps <= p``, the slot is
    valid (``s < kv_len``, or ``ps >= 0`` with ``kv_positions``, which then
    overrides ``kv_len``) and, with a window ``w > 0``, ``p - ps < w``.
    ``logit_softcap`` caps the scaled logits (``tanh(x / c) * c``; 0 or None:
    no cap); ``sinks`` add one logit per query head, dropped after the
    softmax. Returns ``[B, T, n_q, hd]`` in ``q.dtype``."""
    b, t, n_q, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, t, n_kv, group, hd).to(torch.float32)
    logits = torch.einsum("btkgh,bskh->bkgts", qf, k.to(torch.float32)) * scale
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if kv_positions is not None:
        kv_pos = kv_positions.to(torch.int64)  # [B, S]
        valid = kv_pos >= 0
    else:
        kv_pos = torch.arange(s, device=q.device)[None]  # [1, S]
        valid = (kv_pos < kv_len.to(q.device)[:, None]).expand(b, s)
    qp = q_positions.to(device=q.device, dtype=torch.int64)
    mask = valid[:, None, :] & (kv_pos[:, None, :] <= qp[:, :, None])  # [B, T, S]
    if sliding_window is not None and sliding_window > 0:
        mask = mask & (qp[:, :, None] - kv_pos[:, None, :] < sliding_window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    if sinks is not None:
        sink = sinks.reshape(n_kv, group).to(torch.float32)[None, :, :, None, None]
        logits = torch.cat([logits, sink.expand(b, n_kv, group, t, 1)], dim=-1)
        probs = torch.softmax(logits, dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.to(torch.float32))
    return out.reshape(b, t, n_q, hd).to(q.dtype)
