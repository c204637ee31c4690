"""GGUF → model weights loader for ``arch = llama`` (counterpart of
``mistralrs_tpu/models/gguf_loader.py``).

Maps ``blk.N.*`` tensor names onto the port's per-layer weight list, undoes
llama.cpp's HF→GGUF RoPE row permutation on ``attn_q``/``attn_k`` (so one
rotate-half RoPE serves every weight source), keeps Q4_K/Q6_K/Q8_0 tensors
planar (:class:`QTensor`) and dequantizes norms and dense tensors. Per-layer
quant types may differ (Q4_K_M files store half of ``ffn_down`` in Q6_K):
each layer keeps its own type, since layers are not stacked here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.planar import PLANAR_TYPES, PlanarQuant, dequantize, to_planar
from ..gguf.reader import GGUFContent
from ..quant.qtensor import QTensor
from .config import ModelConfig, config_from_gguf
from .llama import check_supported

_DENSE_TYPES = {GGMLType.F32, GGMLType.F16, GGMLType.BF16}

# GGUF name → layer-weight key (dense llama)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "gate",
    "ffn_up.weight": "up",
    "ffn_down.weight": "down",
}


def _unpermute_rows(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Invert llama.cpp's ``permute()``: GGUF interleaved-RoPE row order →
    HF rotate-half row order."""
    n, k = w.shape
    hd = n // n_heads
    return w.reshape(n_heads, hd // 2, 2, k).swapaxes(1, 2).reshape(n, k)


def _unpermute_planar(p: PlanarQuant, shape: tuple[int, int], n_heads: int) -> PlanarQuant:
    n, k = shape
    gs = p.group_size
    perm = _unpermute_rows(np.arange(n)[:, None], n_heads)[:, 0]
    return PlanarQuant(
        q=p.q.reshape(n, k)[perm].reshape(-1),
        scale=p.scale.reshape(n, k // gs)[perm].reshape(-1),
        bias=None if p.bias is None else p.bias.reshape(n, k // gs)[perm].reshape(-1),
        group_size=gs, code_bits=p.code_bits, signed=p.signed,
    )


def _load(content: GGUFContent, name: str, *, dense: bool, dtype, device,
          unpermute_heads: int = 0):
    info = content.tensor_info(name)
    raw = content.tensor_bytes(name)
    shape = tuple(info.shape)
    if dense or info.ggml_type in _DENSE_TYPES:
        w = dequantize(raw, info.ggml_type, shape)
        if unpermute_heads:
            w = _unpermute_rows(w, unpermute_heads)
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype)
    if info.ggml_type not in PLANAR_TYPES:
        raise NotImplementedError(f"{name}: GGML type {info.ggml_type!r} is not ported")
    p = to_planar(raw, info.ggml_type)
    if unpermute_heads:
        p = _unpermute_planar(p, shape, unpermute_heads)
    return QTensor.from_planar(p, shape, ggml_type=info.ggml_type, device=device)


def load_gguf_model(
    path: str, dtype=torch.bfloat16, device: torch.device | str = "cpu"
) -> tuple[ModelConfig, dict, dict[str, Any]]:
    """Load a llama GGUF checkpoint → (config, weights, metadata)."""
    content = GGUFContent.open(path)
    try:
        md = content.metadata
        cfg = config_from_gguf(md)
        if cfg.arch != "llama":
            raise NotImplementedError(f"GGUF arch {cfg.arch!r}: only llama is ported")
        check_supported(cfg)

        def load(name, dense=False, heads=0):
            return _load(content, name, dense=dense, dtype=dtype, device=device,
                         unpermute_heads=heads)

        embed = load("token_embd.weight")
        if cfg.vocab_size is None:
            cfg.vocab_size = (embed.out_features if isinstance(embed, QTensor)
                              else embed.shape[0])
        layers = []
        for i in range(cfg.num_layers):
            lw = {}
            for suffix, key in _LAYER_MAP.items():
                name = f"blk.{i}.{suffix}"
                if name not in content:
                    continue
                heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}.get(key, 0)
                lw[key] = load(name, dense=key.endswith("norm"), heads=heads)
            missing = set(_LAYER_MAP.values()) - set(lw)
            if missing:
                raise ValueError(f"layer {i}: missing tensors {sorted(missing)}")
            layers.append(lw)
        weights = {
            "embed": embed,
            "layers": layers,
            "final_norm": load("output_norm.weight", dense=True),
            "lm_head": load("output.weight") if "output.weight" in content else None,
        }
    finally:
        content.close()
    return cfg, weights, md
