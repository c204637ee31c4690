"""GGUF → model weights loader for ``arch = llama`` (counterpart of
``mistralrs_tpu/models/gguf_loader.py``).

Maps ``blk.N.*`` tensor names onto the port's per-layer weight list, undoes
llama.cpp's HF→GGUF RoPE row permutation on ``attn_q``/``attn_k`` (so one
rotate-half RoPE serves every weight source), keeps Q4_K/Q6_K/Q8_0 tensors
planar (:class:`QTensor`) and dequantizes norms and dense tensors. Per-layer
quant types may differ (Q4_K_M files store half of ``ffn_down`` in Q6_K):
each layer keeps its own type, since layers are not stacked here.

Mixtral files (``llama.expert_count`` > 0) carry each layer's experts as
``blk.N.ffn_{gate,up,down}_exps.weight`` of shape ``[E, out, in]`` and the
router as ``blk.N.ffn_gate_inp.weight``. A bank is loaded whole, as one
:class:`QTensor` with a bank axis in its own GGML type (the JAX loader
widens layers of mixed types to int8 / group 16, an exact re-expression at
1.5 B per weight that the port skips), or as a dense ``[E, out, in]`` tensor
when the file keeps it in F16/BF16/F32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
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
_DENSE_MLP = ("gate", "up", "down")
# MoE layers: the router and the expert banks take the dense MLP's place
_MOE_MAP = {
    "ffn_gate_inp.weight": "router",
    "ffn_gate_exps.weight": "gate",
    "ffn_up_exps.weight": "up",
    "ffn_down_exps.weight": "down",
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
    """One tensor: dense (``dtype``) or planar; a 3-D ``[E, out, in]`` expert
    tensor becomes a bank."""
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
    path: str, dtype=torch.bfloat16, device: DeviceLike = None
) -> tuple[ModelConfig, dict, dict[str, Any]]:
    """Load a llama (or Mixtral) GGUF checkpoint → (config, weights,
    metadata), the weights on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``)."""
    device = resolve_device(device)
    content = GGUFContent.open(path)
    try:
        md = content.metadata
        cfg = config_from_gguf(md)
        if cfg.arch != "llama":
            raise NotImplementedError(
                f"GGUF arch {cfg.arch!r}: only llama is ported (Gemma-2 loads from its "
                "Hugging Face directory: GGUF metadata carries no softcaps)")
        check_supported(cfg)

        def load(name, dense=False, heads=0):
            return _load(content, name, dense=dense, dtype=dtype, device=device,
                         unpermute_heads=heads)

        embed = load("token_embd.weight")
        if cfg.vocab_size is None:
            cfg.vocab_size = (embed.out_features if isinstance(embed, QTensor)
                              else embed.shape[0])
        moe = cfg.num_experts > 0
        want = set(_LAYER_MAP.values()) - (set(_DENSE_MLP) if moe else set())
        layers = []
        for i in range(cfg.num_layers):
            lw = {}
            for suffix, key in _LAYER_MAP.items():
                name = f"blk.{i}.{suffix}"
                if name not in content:
                    continue
                heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}.get(key, 0)
                lw[key] = load(name, dense=key.endswith("norm"), heads=heads)
            if moe:
                moe_w = {key: load(f"blk.{i}.{suffix}") for suffix, key in _MOE_MAP.items()
                         if f"blk.{i}.{suffix}" in content}
                if set(moe_w) != set(_MOE_MAP.values()):
                    raise ValueError(f"layer {i}: MoE tensors missing: "
                                     f"{sorted(set(_MOE_MAP.values()) - set(moe_w))}")
                lw["router"] = moe_w.pop("router")
                lw["experts"] = moe_w
            missing = want - set(lw)
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
