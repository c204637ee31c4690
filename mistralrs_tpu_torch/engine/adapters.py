"""Arch adapters: serve model families that are not the llama-family decoder
through the engine (counterpart of ``mistralrs_tpu/engine/adapters.py``).

The engine drives one loop (scheduler, paged block accounting, fixed-slot
sampler) and an adapter supplies the family's cache and forward:

* :class:`DeepseekAdapter` — absorbed MLA over a paged latent pool, and
  DeepSeek-MoE (DeepSeek V2/V3, GLM-4-MoE-Lite).

The engine samples from the logits an adapter returns (the JAX adapters'
``decode`` samples inside its jitted step). Speculative ``verify`` and
per-request LoRA are not ported.
"""

from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..models.deepseek import (
    LatentCache,
    deepseek_forward_paged,
    kernel_workspace,
    make_paged_cache,
)
from .engine import weights_to


class DeepseekAdapter:
    """Serve DeepSeek V2/V3 (absorbed MLA + DeepSeek-MoE) through the
    engine, on ``device`` (``cuda`` unless the caller asks for ``"cpu"``;
    the weights are moved there). The latent pool is pure KV, so prefix
    caching and recompute preemption need nothing more."""

    supports_prefix_cache = True
    supports_kv_quant = True  # a 1-byte latent pool (models/deepseek.py)

    def __init__(self, cfg, weights: dict, compute_dtype=torch.bfloat16,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.weights = weights_to(weights, self.device)
        self.compute_dtype = compute_dtype
        self._block_size = None

    def create_cache(self, num_blocks: int, block_size: int, n_slots: int,
                     kv_quant=None) -> LatentCache:
        self._block_size = block_size
        return make_paged_cache(self.cfg, num_blocks, block_size, dtype=self.compute_dtype,
                                kv_quant=kv_quant, device=self.device)

    def kernel_workspace(self, batch: int, rows, widths, sms: int) -> tuple[int, int]:
        """The kernels' split state a forward takes
        (``models/deepseek.py::kernel_workspace``)."""
        return kernel_workspace(self.weights, self.cfg, batch, rows, widths, self._block_size,
                                sms)

    def kv_bytes_per_token(self, kv_quant=None) -> int:
        """Latent-pool bytes one token takes over all layers (with
        ``kv_quant``: 1-byte codes and one bf16 scale a row)."""
        if kv_quant:
            return self.cfg.num_layers * (self.cfg.row_dim + 2)
        size = torch.empty((), dtype=self.compute_dtype).element_size()
        return self.cfg.num_layers * self.cfg.row_dim * size

    def _forward(self, cache, ids, positions, bt, slot_map, kv_lens, last_indices=None):
        return deepseek_forward_paged(
            self.weights, self.cfg, ids, positions, cache, bt, slot_map, kv_lens,
            block_size=self._block_size, compute_dtype=self.compute_dtype,
            logits_last_only=True, last_indices=last_indices,
        )

    def prefill(self, cache, ids, positions, bt, slot_map, kv_lens, last_indices):
        """One batched prompt chunk → ``(logits [R, 1, V] at each row's last
        valid token, cache)``."""
        return self._forward(cache, ids, positions, bt, slot_map, kv_lens, last_indices)

    def decode(self, cache, tokens, positions, bt, slot_map, kv_lens):
        """One decode step of the fixed slot batch (``tokens [B, 1]``) →
        ``(logits [B, 1, V], cache)``."""
        return self._forward(cache, tokens, positions, bt, slot_map, kv_lens)
