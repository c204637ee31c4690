"""Importance matrices for in-situ quantization (counterpart of
``mistralrs_tpu/imatrix.py``: ``ImatrixCollector`` :36-68, ``save_imatrix``
:71, ``load_imatrix`` :80 and ``imatrix_rows_for_key`` :85, with its
``_KEY_MAP`` :28-33).

An importance matrix is an ``.npz`` of per-layer rows ``[L, K]``: the mean
squared input of each column of a projection over a calibration corpus,
under four taps (``attn_in`` for q/k/v, ``o_in`` for o, ``mlp_in`` for
gate/up, ``down_in`` for down). ``gguf/quants.py::quantize`` takes a row as
its ``weights``, which Q4_K and Q5_K fit with. :class:`ImatrixCollector`
writes such a file: it runs calibration batches through
``models/llama.py::forward`` over a fresh f32 contiguous cache, in f32
compute, with the forward's taps on (``collect_moments``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device, weights_device
from .kv.contiguous import KVCache
from .models.config import ModelConfig
from .models.llama import forward

# imatrix tap → the layer weight keys (JAX names) it covers
_KEY_MAP = {
    "attn_in": ("wq", "wk", "wv", "wqkv"),
    "o_in": ("wo",),
    "mlp_in": ("gate", "up", "wgateup"),
    "down_in": ("down",),
}


class ImatrixCollector:
    """Accumulates per-layer activation second moments over calibration
    batches (JAX ``ImatrixCollector``), on ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``), where the weights must lie."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sums: Optional[dict[str, np.ndarray]] = None
        self.tokens = 0

    def update(self, weights: dict, input_ids) -> None:
        """Run one calibration batch ``[B, T]`` from position 0 through a
        fresh f32 cache in f32 compute and add its Σx² to the sums."""
        dev = weights_device(weights, self.device)
        ids = torch.as_tensor(np.asarray(input_ids, np.int64), device=dev)
        b, t = ids.shape
        cache = KVCache.create(self.cfg, b, t, dtype=torch.float32, device=dev)
        positions = torch.arange(t, device=dev)[None].expand(b, t)
        _, _, moments = forward(weights, self.cfg, ids, positions, cache, [0] * b,
                                compute_dtype=torch.float32, collect_moments=True,
                                logits_last_only=True)
        moments = {k: v.cpu().numpy() for k, v in moments.items()}
        if self.sums is None:
            self.sums = moments
        else:
            for k, v in moments.items():
                self.sums[k] = self.sums[k] + v
        self.tokens += b * t

    def finalize(self) -> dict[str, np.ndarray]:
        """Mean squared activations: ``{tap: [L, dim] f32}``."""
        if self.sums is None:
            raise ValueError("no calibration batches collected")
        return {k: (v / max(self.tokens, 1)).astype(np.float32) for k, v in self.sums.items()}


def save_imatrix(path, imatrix: Mapping[str, np.ndarray]) -> None:
    """Write the taps as an ``.npz`` (what :func:`load_imatrix` reads)."""
    np.savez(path, **dict(imatrix))


def load_imatrix(path) -> dict[str, np.ndarray]:
    """The taps of an ``.npz`` importance matrix, ``{tap: [L, K] f32}``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def imatrix_rows_for_key(imatrix: Optional[Mapping[str, np.ndarray]],
                         key: str) -> Optional[np.ndarray]:
    """The per-layer importance rows ``[L, K]`` of a layer weight key (JAX
    ``build_stacked``'s names), or None where no tap covers it."""
    if imatrix is None:
        return None
    for tap, keys in _KEY_MAP.items():
        if key in keys and tap in imatrix:
            return np.asarray(imatrix[tap])
    return None
