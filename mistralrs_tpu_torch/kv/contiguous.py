"""Contiguous KV caches of the library forward (counterparts of
``mistralrs_tpu/models/llama.py``'s ``KVCache`` :88-102, ``_write_kv``
:108-116, ``RotatingKVCache`` :117-153, ``HybridKVCache`` :155-209,
``hybrid_layer_maps`` :212-222 and ``_write_kv_ring`` :225-238).

Each cache is a set of device tensors that ``models/llama.py::forward``
writes in place at per-row offsets, which the caller knows on the host
(``starts``: a list of ints, one a row).

* :class:`KVCache`: k/v ``[L, B, S, n_kv, hd]``, ``S`` the capacity. A
  write past the capacity raises: JAX ``_write_kv`` uses
  ``dynamic_update_slice``, which clamps such a write onto the buffer's
  tail (ROADMAP Queue 3 item 12).
* :class:`RotatingKVCache`: a ring of ``window`` slots a layer for a model
  whose layers all slide by that window; ``slot_pos [B, W]`` holds each
  slot's position (-1: empty). Position ``p`` lands in slot ``p % W``; of a
  chunk longer than the window only its last ``W`` rows are kept.
* :class:`HybridKVCache`: a per-layer mix of full and sliding layers (one
  window width): the full layers share a ``[n_full, B, S, ...]`` pool, the
  sliding ones a ``[n_win, B, W, ...]`` ring with one ``slot_pos``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from ..models.config import ModelConfig


def layer_windows(cfg: "ModelConfig") -> np.ndarray:
    """``models/config.py::layer_windows``, imported at the call: the models
    package imports this module."""
    from ..models.config import layer_windows as windows

    return windows(cfg)


@dataclass
class KVCache:
    """Fixed-capacity cache: k/v ``[L, B, S, n_kv, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def _ring_width(cfg: ModelConfig, what: str) -> int:
    widths = sorted({int(x) for x in layer_windows(cfg) if int(x)})
    if not widths:
        raise ValueError(f"{what} needs sliding-window layers")
    if len(widths) != 1:
        raise ValueError(f"{what}: one ring width supported, got {widths}")
    return widths[0]


@dataclass
class RotatingKVCache:
    """Ring cache of a uniformly sliding model: k/v ``[L, B, W, n_kv, hd]``
    and ``slot_pos [B, W]`` int32 (each slot's position, -1 empty)."""

    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    window: int

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> "RotatingKVCache":
        if not cfg.sliding_window:
            raise ValueError("RotatingKVCache needs cfg.sliding_window")
        w = int(cfg.sliding_window)
        if not all(int(x) == w for x in layer_windows(cfg)):
            raise ValueError("RotatingKVCache: per-layer window mix (hybrid) unsupported")
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   torch.full((batch, w), -1, dtype=torch.int32, device=dev), w)


@dataclass
class HybridKVCache:
    """Full pools ``[n_full, B, S, n_kv, hd]`` for the full-attention
    layers, ring pools ``[n_win, B, W, n_kv, hd]`` for the sliding ones, and
    the ring's ``slot_pos [B, W]``; :func:`hybrid_layer_maps` gives each
    layer's pool."""

    k_full: torch.Tensor
    v_full: torch.Tensor
    k_win: torch.Tensor
    v_win: torch.Tensor
    slot_pos: torch.Tensor
    window: int

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> "HybridKVCache":
        w = _ring_width(cfg, "HybridKVCache")
        dev = resolve_device(device)
        n_win = int(np.count_nonzero(layer_windows(cfg)))
        n_full = cfg.num_layers - n_win
        kv = (cfg.num_kv_heads, cfg.head_dim)

        def zeros(n, s):
            return torch.zeros((max(n, 1), batch, s, *kv), dtype=dtype, device=dev)

        return cls(zeros(n_full, capacity), zeros(n_full, capacity), zeros(n_win, w),
                   zeros(n_win, w), torch.full((batch, w), -1, dtype=torch.int32, device=dev),
                   w)

    @property
    def capacity(self) -> int:
        return self.k_full.shape[2]


def hybrid_layer_maps(cfg: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    """``(kinds [L], idx [L])``: 1 for a sliding (ring) layer, 0 for a full
    one, and each layer's index in its kind's pool."""
    kinds = (layer_windows(cfg) > 0).astype(np.int32)
    idx = np.zeros(cfg.num_layers, np.int32)
    seen = {0: 0, 1: 0}
    for i, kind in enumerate(kinds.tolist()):
        idx[i] = seen[kind]
        seen[kind] += 1
    return kinds, idx


def write_kv(layer: torch.Tensor, new: torch.Tensor, starts: Sequence[int]) -> None:
    """Write ``new [B, T, n_kv, hd]`` into ``layer [B, S, n_kv, hd]`` in
    place, row ``b`` at offset ``starts[b]``. Raises when a row's write
    would pass the capacity ``S``."""
    t, s = new.shape[1], layer.shape[1]
    for row, start in enumerate(starts):
        if start < 0 or start + t > s:
            raise ValueError(f"KV write of {t} tokens at offset {start} (row {row}) passes "
                             f"the cache's capacity of {s}")
    if len(set(starts)) == 1:
        layer[:, starts[0]:starts[0] + t] = new
    else:
        for row, start in enumerate(starts):
            layer[row, start:start + t] = new[row]


def _ring_spans(start: int, t: int, window: int):
    """``(chunk offset, first position, slot, count)`` of the at most two
    contiguous slot runs that positions ``start .. start + t`` take in a
    ring of ``window`` slots, keeping the last ``window`` of them."""
    off = max(0, t - window)
    p0, n = start + off, t - off
    first = p0 % window
    n1 = min(n, window - first)
    spans = [(off, p0, first, n1)]
    if n > n1:
        spans.append((off + n1, p0 + n1, 0, n - n1))
    return spans


def write_kv_ring(layer: torch.Tensor, new: torch.Tensor, starts: Sequence[int],
                  window: int) -> None:
    """Ring write in place: the token at position ``p`` lands in slot
    ``p % window`` of ``layer [B, W, n_kv, hd]``; of a chunk longer than the
    window only its last ``window`` tokens stay."""
    t = new.shape[1]
    if len(set(starts)) == 1:
        for off, _, slot, n in _ring_spans(starts[0], t, window):
            layer[:, slot:slot + n] = new[:, off:off + n]
        return
    for row, start in enumerate(starts):
        for off, _, slot, n in _ring_spans(start, t, window):
            layer[row, slot:slot + n] = new[row, off:off + n]


def advance_ring(slot_pos: torch.Tensor, starts: Sequence[int], t: int, window: int) -> None:
    """Record in ``slot_pos [B, W]`` the positions a chunk of ``t`` tokens
    at ``starts`` wrote into the ring (in place)."""
    for row, start in enumerate(starts):
        for _, p0, slot, n in _ring_spans(start, t, window):
            slot_pos[row, slot:slot + n] = torch.arange(p0, p0 + n, dtype=slot_pos.dtype,
                                                        device=slot_pos.device)
