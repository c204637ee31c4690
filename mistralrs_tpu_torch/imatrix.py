"""Importance matrices for in-situ quantization (counterpart of
``mistralrs_tpu/imatrix.py``: ``load_imatrix`` :80 and
``imatrix_rows_for_key`` :85, with its ``_KEY_MAP`` :28-33).

An importance matrix is an ``.npz`` of per-layer rows ``[L, K]``: the mean
squared input of each column of a projection over a calibration corpus,
under four taps (``attn_in`` for q/k/v, ``o_in`` for o, ``mlp_in`` for
gate/up, ``down_in`` for down). ``gguf/quants.py::quantize`` takes a row as
its ``weights``, which Q4_K and Q5_K fit with. The JAX package's
``ImatrixCollector``, which writes such a file, is not ported: it runs the
model's forward over the contiguous KV cache, which the port lacks.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

# imatrix tap → the layer weight keys (JAX names) it covers
_KEY_MAP = {
    "attn_in": ("wq", "wk", "wv", "wqkv"),
    "o_in": ("wo",),
    "mlp_in": ("gate", "up", "wgateup"),
    "down_in": ("down",),
}


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
