"""Hugging Face checkpoints (counterpart of
``mistralrs_tpu/models/hf_loader.py``): a safetensors reader with its own
parser (the ``safetensors`` package is not needed), and the llama-family
loader (``weights_from_state_dict``, ``load_hf_model``) for dense
checkpoints.

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(plus an optional ``__metadata__`` entry), then the raw little-endian data,
offsets counted from the end of the header. A directory holds one file or
the shards named by ``model.safetensors.index.json``.

The loader takes dense bf16, f16 or f32 tensors: the attention and MLP
projections, the norms (Gemma-2's pre- and post-norms through the JAX
package's ``_GEMMA_LAYER_MAP``), Mixtral's router and expert banks, the
embedding, and the head (tied to the embedding when the checkpoint has no
``lm_head.weight``, as the JAX loader does whatever ``tie_word_embeddings``
says). Everything else raises ``NotImplementedError`` naming it: quantized
checkpoints (GPTQ, AWQ, bitsandbytes: a ``quantization_config``), phi3's
fused projections, biases, and expert banks other than Mixtral's. In-situ
quantization, UQFF overlays, importance matrices and topologies are not
ported: the loader takes no such argument.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .config import ModelConfig, config_from_hf
from .llama import check_supported

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file as a CPU tensor in its own
    dtype (F32, F16 or BF16; other dtypes raise). The file is memory-mapped
    and each tensor copied out of it."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{path.name}: {name} has dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        raw = torch.from_numpy(np.array(data[begin:end]))  # a copy, owned by torch
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def load_safetensors_dir(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """All tensors of a model directory: the shards of
    ``model.safetensors.index.json`` where it exists, else every
    ``*.safetensors`` file."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        files = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        files = [path / f for f in files]
    else:
        files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


# HF tensor names of a llama-family layer → the port's layer keys (the
# dense subset of JAX hf_loader.py's _HF_LAYER_MAP)
_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "post_attention_layernorm.weight": "ffn_norm",
    "mlp.gate_proj.weight": "gate",
    "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down",
    "pre_feedforward_layernorm.weight": "ffn_norm",  # gemma2/3
    "post_feedforward_layernorm.weight": "post_ffn_norm",
    "block_sparse_moe.gate.weight": "router",  # mixtral
}
# gemma2/3 use post_attention_layernorm as the *post* norm and
# pre_feedforward_layernorm as the pre-FFN norm
_GEMMA_LAYER_MAP = dict(_HF_LAYER_MAP)
_GEMMA_LAYER_MAP["post_attention_layernorm.weight"] = "post_attn_norm"
# Mixtral's expert banks: block_sparse_moe.experts.N.{w1, w3, w2}
_MIXTRAL_EXPERTS = {"w1": "gate", "w3": "up", "w2": "down"}


def weights_from_state_dict(
    sd: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    dtype=torch.bfloat16,
    device: DeviceLike = None,
    quant_config: Optional[Mapping[str, Any]] = None,
) -> dict:
    """The port's llama-family weight dict (``models/llama.py``) from a HF
    state dict of dense tensors, every leaf cast to ``dtype`` on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``): JAX
    ``weights_from_state_dict``'s dense path, the
    same tensors to the same weights. A tensor of any other name (biases,
    phi3's fused projections, q/k norms, sinks, expert banks other than
    Mixtral's) raises ``NotImplementedError`` naming it."""
    if quant_config:
        raise NotImplementedError(
            f"HF loader: quantized checkpoint (quantization_config "
            f"{quant_config.get('quant_method')!r}: GPTQ, AWQ and bitsandbytes) not ported yet")
    check_supported(cfg)
    dev = resolve_device(device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    layer_map = _GEMMA_LAYER_MAP if cfg.arch in ("gemma2", "gemma3") else _HF_LAYER_MAP
    experts = {f"block_sparse_moe.experts.{j}.{w}.weight": (j, key)
               for j in range(cfg.num_experts) for w, key in _MIXTRAL_EXPERTS.items()}
    known = {prefix + "embed_tokens.weight", prefix + "norm.weight", "lm_head.weight"}
    for i in range(cfg.num_layers):
        known.update(f"{prefix}layers.{i}.{suffix}" for suffix in (*layer_map, *experts))
    unknown = sorted(n for n in sd if n not in known and not n.endswith("rotary_emb.inv_freq"))
    if unknown:
        raise NotImplementedError(f"HF loader: tensors not ported: {unknown[:8]}")

    def take(name: str) -> Optional[torch.Tensor]:
        t = sd.get(name)
        return None if t is None else t.to(device=dev, dtype=dtype)

    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}layers.{i}."
        lw = {key: t for suffix, key in layer_map.items() if (t := take(lp + suffix)) is not None}
        if cfg.num_experts:
            bank: dict[str, list] = {key: [None] * cfg.num_experts
                                     for key in _MIXTRAL_EXPERTS.values()}
            for suffix, (j, key) in experts.items():
                bank[key][j] = take(lp + suffix)
            if all(x is not None for xs in bank.values() for x in xs):
                lw["experts"] = {key: torch.stack(xs) for key, xs in bank.items()}
        want = {"attn_norm", "ffn_norm", "wq", "wk", "wv", "wo"} | (
            {"router", "experts"} if cfg.num_experts else {"gate", "up", "down"})
        missing = want - set(lw)
        if missing:
            raise ValueError(f"HF loader: layer {i} lacks {sorted(missing)}")
        layers.append(lw)
    embed = take(prefix + "embed_tokens.weight")
    final_norm = take(prefix + "norm.weight")
    if embed is None or final_norm is None:
        raise ValueError("HF loader: embed_tokens.weight or norm.weight missing")
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": final_norm,
        "lm_head": take("lm_head.weight"),  # None: tied to the embedding
    }


def load_hf_model(
    path: str | os.PathLike,
    *,
    dtype=torch.bfloat16,
    device: DeviceLike = None,
) -> tuple[ModelConfig, dict, dict[str, Any]]:
    """A llama-family HF directory (``config.json`` + safetensors) →
    ``(config, weights on device, config dict)``."""
    path = Path(path)
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = config_from_hf(hf_cfg)
    weights = weights_from_state_dict(load_safetensors_dir(path), cfg, dtype=dtype,
                                      device=device,
                                      quant_config=hf_cfg.get("quantization_config"))
    return cfg, weights, hf_cfg
