"""GGUF → model weights loader (counterpart of
``mistralrs_tpu/models/gguf_loader.py``) for the archs ``llama`` (Mixtral
included), ``mistral``, ``qwen2`` (Qwen2 and Qwen2.5), ``qwen3`` and
``qwen3moe``.

Maps ``blk.N.*`` tensor names onto the port's per-layer weight list as the
JAX ``_LAYER_MAP`` does (``mistralrs_tpu/models/gguf_loader.py:117-136``):
the projections, Qwen2's ``attn_{q,k,v}.bias`` (and an ``attn_output.bias``
where a file has one) and Qwen3's ``attn_{q,k}_norm.weight``, norms and
biases dense. llama.cpp permutes the ``attn_q``/``attn_k`` rows of ``llama``
files for its interleaved RoPE; the loader undoes that for ``llama`` only
and ``mistral`` (JAX ``_PERMUTED_QK_ARCHS``, :33; its third, ``granite``,
is refused below), so one rotate-half RoPE serves every weight source.
Qwen files are not permuted.

Every planar type (``gguf/planar.py``: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K,
Q3_K, Q4_K, Q5_K, Q6_K) stays planar (:class:`QTensor`): each tensor's raw
blocks are copied to ``device`` and decoded there. Q8_1 and Q8_K tensors
load as dense weights, as the JAX loader dequantizes them. Each layer keeps its
own GGML type (Q4_K_M files store half of ``ffn_down`` and ``attn_v`` in
Q6_K), and each expert bank its own: the port does not stack layers, so
it needs no counterpart of the JAX loader's ``widen_planar``, which
re-expresses mixed layers as int8 codes at group 16 (1.5 B a weight) so
that they stack.

MoE files (``<arch>.expert_count`` > 0: Mixtral as ``llama``, Qwen3-MoE)
carry each layer's experts as ``blk.N.ffn_{gate,up,down}_exps.weight`` of
shape ``[E, out, in]`` and the router as ``blk.N.ffn_gate_inp.weight``. A
bank is loaded whole, as one :class:`QTensor` with a bank axis, or as a
dense ``[E, out, in]`` tensor when the file keeps it in F16/BF16/F32.

Refused by name: ``gemma2`` and ``gemma3`` (the JAX GGUF path reads none
of their softcap, attention-scale or local rope-base keys and adds gemma's 1
to norms that llama.cpp stored with it; both load from their Hugging Face
directories), ``qwen2moe`` (the JAX GGUF path maps
no ``ffn_*_shexp`` tensors and reads no shared-expert width, so it would
drop the shared expert), ``granite`` (the JAX GGUF config reads none of
its multipliers), and every other arch.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .._device import DeviceLike, resolve_device
from ..gguf.constants import GGMLType
from ..gguf.planar import (
    DENSE_ONLY_TYPES,
    PLANAR_TYPES,
    PlanarQuant,
    as_bytes,
    dequantize,
    to_planar,
)
from ..gguf.reader import GGUFContent
from ..quant.qtensor import QTensor
from .config import ModelConfig, config_from_gguf
from .llama import check_supported

_DENSE_TYPES = {GGMLType.F32, GGMLType.F16, GGMLType.BF16}

# the GGUF archs served, and those whose q/k rows llama.cpp permuted
GGUF_ARCHS = ("llama", "mistral", "qwen2", "qwen3", "qwen3moe")
_PERMUTED_QK_ARCHS = {"llama", "mistral"}
# archs refused by name, with the reason
REFUSED_ARCHS = {
    "gemma2": "the JAX GGUF path reads no softcap or attention-scale key and adds gemma's 1 "
              "to norms that llama.cpp stored with it; Gemma-2 loads from its Hugging Face "
              "directory",
    "gemma3": "the JAX GGUF path reads no attention-scale or local rope-base key and adds "
              "gemma's 1 to norms that llama.cpp stored with it; Gemma-3 text loads from its "
              "Hugging Face directory",
    "qwen2moe": "the JAX GGUF path maps no ffn_*_shexp tensors and reads no shared-expert "
                "width, so it would drop the shared expert; qwen2moe loads from its Hugging "
                "Face directory",
    "granite": "the JAX GGUF config reads none of granite's embedding, residual, attention "
               "and logit multipliers",
}

# GGUF name → layer-weight key (llama superfamily)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "attn_q.bias": "wq_bias",
    "attn_k.bias": "wk_bias",
    "attn_v.bias": "wv_bias",
    "attn_output.bias": "wo_bias",
    "attn_q_norm.weight": "q_norm",
    "attn_k_norm.weight": "k_norm",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "gate",
    "ffn_up.weight": "up",
    "ffn_down.weight": "down",
}
_DENSE_MLP = ("gate", "up", "down")
_REQUIRED = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm")
# MoE layers: the router and the expert banks take the dense MLP's place
_MOE_MAP = {
    "ffn_gate_inp.weight": "router",
    "ffn_gate_exps.weight": "gate",
    "ffn_up_exps.weight": "up",
    "ffn_down_exps.weight": "down",
}


def _is_dense_key(key: str) -> bool:
    """Norms and biases load dense, whatever their GGML type (JAX
    ``dequant_small``)."""
    return key.endswith("norm") or key.endswith("_bias")


def _unpermute_index(n: int, n_heads: int, device) -> torch.Tensor:
    """The row order that inverts llama.cpp's ``permute()``: GGUF
    interleaved-RoPE row order → HF rotate-half row order."""
    hd = n // n_heads
    return (torch.arange(n, device=device).reshape(n_heads, hd // 2, 2)
            .transpose(1, 2).reshape(n))


def _unpermute_planar(p: PlanarQuant, shape: tuple[int, int], n_heads: int) -> PlanarQuant:
    n, k = shape
    gs = p.group_size
    perm = _unpermute_index(n, n_heads, p.q.device)
    return PlanarQuant(
        q=p.q.reshape(n, k)[perm].reshape(-1),
        scale=p.scale.reshape(n, k // gs)[perm].reshape(-1),
        bias=None if p.bias is None else p.bias.reshape(n, k // gs)[perm].reshape(-1),
        group_size=gs, code_bits=p.code_bits, signed=p.signed,
    )


def _load(content, name: str, *, dense: bool, dtype, device, unpermute_heads: int = 0):
    """One tensor, its raw blocks copied to ``device`` and decoded there:
    dense (``dtype``) or planar; a 3-D ``[E, out, in]`` expert tensor
    becomes a bank."""
    info = content.tensor_info(name)
    raw = as_bytes(content.tensor_bytes(name, device))
    shape = tuple(info.shape)
    if dense or info.ggml_type in _DENSE_TYPES or info.ggml_type in DENSE_ONLY_TYPES:
        w = dequantize(raw, info.ggml_type, shape)
        if unpermute_heads:
            w = w[_unpermute_index(shape[0], unpermute_heads, w.device)]
        return w.to(dtype)
    if info.ggml_type not in PLANAR_TYPES:
        raise NotImplementedError(f"{name}: GGML type {info.ggml_type!r} is not ported")
    p = to_planar(raw, info.ggml_type)
    if unpermute_heads:
        p = _unpermute_planar(p, shape, unpermute_heads)
    return QTensor.from_planar(p, shape, ggml_type=info.ggml_type, device=device)


def check_gguf_arch(arch: str) -> None:
    """Raise ``NotImplementedError`` for a GGUF arch the port does not serve."""
    if arch in REFUSED_ARCHS:
        raise NotImplementedError(f"GGUF arch {arch!r} is not ported: {REFUSED_ARCHS[arch]}")
    if arch not in GGUF_ARCHS:
        raise NotImplementedError(f"GGUF arch {arch!r} is not ported (served: "
                                  f"{', '.join(GGUF_ARCHS)})")


def load_gguf_model(
    path, dtype=torch.bfloat16, device: DeviceLike = None
) -> tuple[ModelConfig, dict, dict[str, Any]]:
    """Load a GGUF checkpoint of a served arch (:data:`GGUF_ARCHS`) →
    (config, weights, metadata), the weights on ``device`` (``cuda`` unless
    the caller asks for ``"cpu"``). ``path`` is a file (split files join) or
    an opened content: anything with ``metadata``, ``tensor_info(name)``
    (``.shape``, ``.ggml_type``), ``tensor_bytes(name, device)`` (a flat
    ``uint8`` tensor on ``device``) and ``in``."""
    device = resolve_device(device)
    opened = isinstance(path, (str, os.PathLike))
    content = GGUFContent.open(path) if opened else path
    try:
        md = content.metadata
        check_gguf_arch(md.get("general.architecture", "unknown"))
        cfg = config_from_gguf(md)
        check_supported(cfg)
        permute_qk = cfg.arch in _PERMUTED_QK_ARCHS

        def load(name, dense=False, heads=0):
            return _load(content, name, dense=dense, dtype=dtype, device=device,
                         unpermute_heads=heads)

        embed = load("token_embd.weight")
        if cfg.vocab_size is None:
            cfg.vocab_size = (embed.out_features if isinstance(embed, QTensor)
                              else embed.shape[0])
        moe = cfg.num_experts > 0
        want = set(_REQUIRED) | (set() if moe else set(_DENSE_MLP))
        if cfg.qk_norm:
            want |= {"q_norm", "k_norm"}
        layers = []
        for i in range(cfg.num_layers):
            lw = {}
            for suffix, key in _LAYER_MAP.items():
                name = f"blk.{i}.{suffix}"
                if name not in content:
                    continue
                heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}.get(key, 0)
                lw[key] = load(name, dense=_is_dense_key(key), heads=heads if permute_qk else 0)
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
            # no output.weight: the head is tied to the embedding
            "lm_head": load("output.weight") if "output.weight" in content else None,
        }
    finally:
        if opened:
            content.close()
    return cfg, weights, md
