"""Weights carried across from the JAX package.

:func:`from_jax_params` turns the JAX package's weight dictionary (stacked
``[L, ...]`` layer leaves, ``QTensor`` planes; the caller converts arrays to
numpy, or passes objects numpy can read) into the port's (a list of
per-layer dictionaries of torch tensors and :class:`QTensor`), so the two
packages compute the same function. This module imports nothing of the JAX
package: a quantized leaf is anything with ``data``, ``scale``, ``bias``,
``group_size``, ``packed`` and ``code_bits`` fields, as a mapping or as
attributes, and an FP8 leaf anything with ``data`` (``[N, K]`` e4m3),
``scale`` and ``block_shape`` (the JAX ``Fp8Tensor``'s fields; it becomes
the port's :class:`Fp8Tensor`, codes K-major). A leaf may also be a torch
tensor on any device (``uqff.py`` reads files so).

Gemma-2's and Gemma-3's post norms (``post_attn_norm``, ``post_ffn_norm``),
Qwen3's and Gemma-3's q/k norms (``q_norm``, ``k_norm``) and Qwen2's q/k/v
biases come across with
the other layer leaves, from HF directories and GGUF files alike, and so
do the planes of every GGUF planar type, plane for plane (Q2_K's 2-bit
codes packed in nibbles at group 16 included). So do the Llama-family
variants' leaves: the LayerNorm biases (``attn_norm_bias``,
``ffn_norm_bias``, and ``final_norm_bias`` beside ``final_norm``), the MLP
biases (``gate_bias``, ``up_bias``, ``down_bias``), a gateless MLP's
``up``/``down``, glm4's post norms, hunyuan's q/k norms and phi2's
``lm_head_bias``. The JAX ``layer_windows`` and ``layer_use_rope`` leaves
are not carried: the port computes each layer's window and RoPE flag from
the config (``models/llama.py::layer_windows``, ``layer_rope_flags``).

gpt-oss's leaves come across in the port's layout: the q/k/v/o biases and
the router bias as they are, the sinks as f32, and the expert banks (JAX
``{gate_up [L, E, H, 2I], gate_up_bias, down [L, E, I, H], down_bias}``,
gate and up interleaved in gate_up's columns) as ``{gateup [E, 2I, H]``
(gate rows, then up rows), ``gateup_bias``, ``down [E, H, I]``,
``down_bias}``, the layout of ``models/hf_loader.py`` (a permutation and
transposes: no value changes).

MoE layers carry their ``router`` (``[L, E, H]``) and ``experts`` (a
mapping of ``[L, E, ...]`` planes or dense ``[L, E, out, in]`` banks) across
as per-layer ``[E, ...]`` banks (Mixtral's, Qwen3-MoE's and qwen2moe's
alike; GPTQ and AWQ banks at any group size, split-half packed or one byte
a code, plane for plane). Banks the JAX loader widened to int8 codes at
group 16 with a bias plane are carried as they are and run through the W8
grouped kernel in its signed-with-bias form. qwen2moe's ``shared_expert``
(``{gate, up, down}`` of stacked ``[L, ...]`` leaves, plain or planar) and
``shared_expert_gate`` (``[L, 1, H]``) come across per layer.

The JAX package's in-situ quantized weights (``load_hf_model(isq=...)``)
come across plane for plane as well: its Q8_0 embedding and head, and its
quantized routers and qwen2moe's shared-expert gates (N = 8, 60, 1), whose
planes are zero-padded to a multiple of 16 rows with their N kept as
``logical_n`` (``QTensor.pad_rows``), as the port's ISQ loader lays them
out for the kernels.

:func:`from_jax_deepseek_params` does the same for the JAX package's
DeepSeek weights (absorbed MLA, DeepSeek-MoE).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.hf_loader import _deinterleave
from .models.llama import check_supported
from .quant.fp8 import Fp8Tensor
from .quant.qtensor import QTensor

_PLANE_FIELDS = ("data", "scale", "bias", "group_size", "packed", "code_bits")
_FP8_FIELDS = ("data", "scale", "block_shape")


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _is_planar(obj) -> bool:
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return False
    if isinstance(obj, dict):
        return all(k in obj for k in _PLANE_FIELDS)
    return all(hasattr(obj, k) for k in _PLANE_FIELDS)


def _is_fp8(obj) -> bool:
    if isinstance(obj, (np.ndarray, torch.Tensor)) or _is_planar(obj):
        return False
    if isinstance(obj, dict):
        return all(k in obj for k in _FP8_FIELDS)
    return all(hasattr(obj, k) for k in _FP8_FIELDS)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """An array (numpy, anything numpy reads, or a torch tensor on any
    device) as a torch tensor on ``device``, cast to ``dtype`` where given;
    ml_dtypes bf16 and float8_e4m3fn arrays keep their values exactly."""
    if isinstance(a, torch.Tensor):
        t = a.to(device)
        return t.to(dtype) if dtype is not None else t
    arr = np.asarray(a)
    if arr.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8: the same bytes
        return torch.from_numpy(np.array(arr.view(np.uint8), order="C")).to(device).view(
            torch.float8_e4m3fn)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly to f32
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(arr, order="C")).to(device)  # a writable copy
    return t.to(dtype) if dtype is not None else t


def _layer(v, layer):
    """Layer ``layer`` of a stacked array (a torch tensor stays one; other
    arrays go through numpy), or the array itself for ``layer=None``."""
    a = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return a if layer is None else a[layer]


def _leaf(obj, device, dtype, layer=None):
    """One weight (or layer ``layer`` of a stacked weight)."""
    if obj is None:
        return None
    if _is_fp8(obj):  # data [N, K] e4m3, scale [] or [nb, kb] (JAX Fp8Tensor's fields)
        bs = _field(obj, "block_shape")
        return Fp8Tensor.from_nk(_tensor(_layer(_field(obj, "data"), layer), device),
                                 _tensor(_layer(_field(obj, "scale"), layer), device,
                                         torch.float32),
                                 None if bs is None else tuple(int(b) for b in bs))
    if _is_planar(obj):
        if int(getattr(obj, "chunks", 1) if not isinstance(obj, dict)
               else obj.get("chunks", 1)) != 1:
            raise NotImplementedError("row-parallel (chunked) packing is not ported")

        def plane(name):
            v = _field(obj, name)
            if v is None:
                return None
            return _tensor(_layer(v, layer), device)

        return QTensor(
            data=plane("data"), scale=plane("scale").to(torch.float32),
            bias=None if _field(obj, "bias") is None else plane("bias").to(torch.float32),
            group_size=int(_field(obj, "group_size")), packed=bool(_field(obj, "packed")),
            code_bits=int(_field(obj, "code_bits")),
        )
    return _tensor(_layer(obj, layer), device, dtype)


def from_jax_params(
    params: dict[str, Any], cfg: ModelConfig, device: DeviceLike = None,
    dtype=torch.bfloat16,
) -> dict:
    """The JAX package's llama weight dict → the port's weight dict on
    ``device`` (``cuda`` unless the caller asks for ``"cpu"``). Dense leaves
    are cast to ``dtype`` (bf16 values stay exact); quantized planes keep
    their integer codes and f32 scales bit for bit."""
    check_supported(cfg)
    device = resolve_device(device)
    stacked = params["layers"]
    gpt_oss = cfg.arch == "gpt_oss"
    known = {"attn_norm", "ffn_norm", "wq", "wk", "wv", "wqkv", "wo", "gate", "up", "wgateup",
             "down", "router", "experts", "post_attn_norm", "post_ffn_norm", "wq_bias",
             "wk_bias", "wv_bias", "wo_bias", "attn_norm_bias", "ffn_norm_bias", "gate_bias",
             "up_bias", "down_bias"} | ({"sinks", "router_bias"} if gpt_oss else set()) | (
                 {"q_norm", "k_norm"} if cfg.qk_norm else set()) | (
                 {"shared_expert", "shared_expert_gate"} if cfg.arch == "qwen2moe" else set())
    unknown = set(stacked) - known
    if unknown:
        raise NotImplementedError(f"layer weights not ported: {sorted(unknown)}")
    experts = stacked.get("experts", {})
    unknown = set(experts) - ({"gate_up", "gate_up_bias", "down", "down_bias"} if gpt_oss
                              else {"gate", "up", "down"})
    if unknown:
        raise NotImplementedError(f"expert weights not ported: {sorted(unknown)}")
    shared = stacked.get("shared_expert", {})
    unknown = set(shared) - {"gate", "up", "down"}
    if unknown:
        raise NotImplementedError(f"shared expert weights not ported: {sorted(unknown)}")

    def gpt_oss_experts(i):
        ex = {key: _leaf(w, device, dtype, layer=i) for key, w in experts.items()}
        return {"gateup": _deinterleave(ex["gate_up"]).transpose(1, 2).contiguous(),
                "gateup_bias": _deinterleave(ex["gate_up_bias"]).contiguous(),
                "down": ex["down"].transpose(1, 2).contiguous(),
                "down_bias": ex["down_bias"]}

    def layer(i):
        lw = {key: _leaf(w, device, dtype, layer=i)
              for key, w in stacked.items() if key not in ("experts", "shared_expert")}
        for key in ("router", "shared_expert_gate"):  # quantized in situ: N padded to 16
            if isinstance(lw.get(key), QTensor):
                lw[key] = lw[key].pad_rows(16)
        if shared:
            lw["shared_expert"] = {key: _leaf(w, device, dtype, layer=i)
                                   for key, w in shared.items()}
        if "sinks" in lw:
            lw["sinks"] = lw["sinks"].to(torch.float32)
        if experts:
            lw["experts"] = gpt_oss_experts(i) if gpt_oss else {
                key: _leaf(w, device, dtype, layer=i) for key, w in experts.items()}
        return lw

    layers = [layer(i) for i in range(cfg.num_layers)]
    out = {
        "embed": _leaf(params["embed"], device, dtype),
        "layers": layers,
        "final_norm": _leaf(params["final_norm"], device, dtype),
        "lm_head": _leaf(params.get("lm_head"), device, dtype),
    }
    for key in ("final_norm_bias", "lm_head_bias"):  # LayerNorm archs; phi2's head
        if params.get(key) is not None:
            out[key] = _leaf(params[key], device, dtype)
    return out


_DEEPSEEK_LAYER_KEYS = {"attn_norm", "ffn_norm", "q", "q_a", "q_a_norm", "q_b", "kv_a",
                        "kv_a_norm", "kv_b", "w_uk", "w_uv", "o", "gate", "up", "down",
                        "router", "router_bias", "experts", "shared"}


def from_jax_deepseek_params(
    params: dict[str, Any], cfg, device: DeviceLike = None, dtype=torch.bfloat16,
) -> dict:
    """The JAX package's absorbed DeepSeek weight dict
    (``deepseek_weights_from_state_dict(..., absorbed=True)``: ``segments``
    ``dense`` and ``moe`` of stacked ``[Lseg, ...]`` leaves, as numpy) → the
    port's (:mod:`~mistralrs_tpu_torch.models.deepseek`) on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``), leaves cast to
    ``dtype``. Each routed-expert bank's gate and up are fused into
    ``gateup``; ``kv_b`` (unused by the absorbed path) is dropped."""
    device = resolve_device(device)
    layers = []
    for seg in ("dense", "moe"):
        stacked = params["segments"].get(seg)
        if stacked is None:
            continue
        unknown = set(stacked) - _DEEPSEEK_LAYER_KEYS
        if unknown:
            raise NotImplementedError(f"DeepSeek layer weights not ported: {sorted(unknown)}")
        for i in range(len(np.asarray(stacked["attn_norm"]))):
            lw = {k: _leaf(v, device, dtype, layer=i) for k, v in stacked.items()
                  if k not in ("experts", "shared", "kv_b")}
            if "experts" in stacked:
                ex = {k: _leaf(v, device, dtype, layer=i) for k, v in stacked["experts"].items()}
                lw["experts"] = {"gateup": torch.cat([ex["gate"], ex["up"]], dim=1),
                                 "down": ex["down"]}
            if "shared" in stacked:
                lw["shared"] = {k: _leaf(v, device, dtype, layer=i)
                                for k, v in stacked["shared"].items()}
            layers.append(lw)
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the weights, config has {cfg.num_layers}")
    return {
        "embed": _leaf(params["embed"], device, dtype),
        "layers": layers,
        "final_norm": _leaf(params["final_norm"], device, dtype),
        "lm_head": _leaf(params.get("lm_head"), device, dtype),
    }


# ---------------------------------------------------------------------------
# HF checkpoint → GGUF (JAX convert.py:23-176: the `quantize` command)
# ---------------------------------------------------------------------------

_PERMUTED_QK_ARCHS = {"llama", "mistral", "granite"}

# the port's layer key → GGUF tensor-name suffix, and HF names → layer keys
_GGUF_NAMES = {
    "attn_norm": "attn_norm.weight", "wq": "attn_q.weight", "wk": "attn_k.weight",
    "wv": "attn_v.weight", "wo": "attn_output.weight", "wq_bias": "attn_q.bias",
    "wk_bias": "attn_k.bias", "wv_bias": "attn_v.bias", "q_norm": "attn_q_norm.weight",
    "k_norm": "attn_k_norm.weight", "ffn_norm": "ffn_norm.weight", "gate": "ffn_gate.weight",
    "up": "ffn_up.weight", "down": "ffn_down.weight",
}
_HF_TO_KEY = {
    "input_layernorm.weight": "attn_norm", "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk", "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo", "self_attn.q_proj.bias": "wq_bias",
    "self_attn.k_proj.bias": "wk_bias", "self_attn.v_proj.bias": "wv_bias",
    "self_attn.q_norm.weight": "q_norm", "self_attn.k_norm.weight": "k_norm",
    "post_attention_layernorm.weight": "ffn_norm", "mlp.gate_proj.weight": "gate",
    "mlp.up_proj.weight": "up", "mlp.down_proj.weight": "down",
}


def tokenizer_metadata_from_hf(tokenizer) -> dict[str, Any]:
    """``tokenizer.ggml.*`` metadata of a byte-level BPE ``tokenizers``
    tokenizer (its vocabulary, added tokens and merges), so that a written
    GGUF file carries its tokenizer; ``{}`` for other models (JAX
    ``tokenizer_metadata_from_hf``)."""
    import json

    data = json.loads(tokenizer.to_str())
    model = data.get("model", {})
    if model.get("type") != "BPE":
        return {}
    vocab = model["vocab"]
    tokens: list = [None] * len(vocab)
    for t, i in vocab.items():
        tokens[i] = t
    for added in data.get("added_tokens", []):
        i = added["id"]
        if i >= len(tokens):
            tokens.extend([None] * (i + 1 - len(tokens)))
        tokens[i] = added["content"]
    merges = [m if isinstance(m, str) else " ".join(m) for m in model.get("merges", [])]
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": [t if t is not None else f"<unused{i}>"
                                  for i, t in enumerate(tokens)],
        "tokenizer.ggml.merges": merges,
    }


def _permute_rows(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """llama.cpp's ``permute()``: HF rotate-half rows → GGUF interleaved rows."""
    n = w.shape[0]
    hd = n // n_heads
    return w.reshape(n_heads, 2, hd // 2, *w.shape[1:]).transpose(1, 2).reshape(w.shape)


def _pick_type(name: str, arr: torch.Tensor, quant):
    from .gguf.constants import GGMLType

    if quant is None or arr.dim() != 2 or "norm" in name or name.endswith("bias"):
        return GGMLType.F32
    if arr.shape[-1] % 256 != 0:
        return GGMLType.F16
    if name in ("token_embd.weight", "output.weight"):  # embeddings and head at Q8_0
        return GGMLType.Q8_0
    return quant


def convert_hf_to_gguf(sd, cfg: ModelConfig, out_path, *, quant=None,
                       tokenizer_metadata=None, imatrix=None,
                       device: DeviceLike = None) -> None:
    """Write a GGUF file from a HF state dict (torch tensors), the JAX
    ``convert_hf_to_gguf``'s bytes: llama.cpp's tensor names and metadata,
    q/k rows permuted for the ``llama``/``mistral``/``granite`` archs,
    norms and biases F32, widths not a multiple of 256 F16, the embedding
    and head Q8_0 and the rest ``quant`` (F32 without one). Each tensor is
    quantized on ``device`` (``cuda`` unless the caller asks for ``"cpu"``)
    as the file is written; ``imatrix`` (``imatrix.py``'s taps) gives each
    layer's Q4_K/Q5_K fit its importance row."""
    import numpy as np

    from .gguf.writer import GGUFWriter
    from .imatrix import imatrix_rows_for_key

    dev = resolve_device(device)
    arch = cfg.arch
    w = GGUFWriter(out_path)
    w.add_metadata("general.architecture", arch)
    w.add_metadata("general.name", f"{arch}-converted")
    for key, value in (("block_count", cfg.num_layers),
                       ("context_length", cfg.max_position_embeddings),
                       ("embedding_length", cfg.hidden_size),
                       ("feed_forward_length", cfg.intermediate_size),
                       ("attention.head_count", cfg.num_heads),
                       ("attention.head_count_kv", cfg.num_kv_heads),
                       ("attention.key_length", cfg.head_dim),
                       ("attention.value_length", cfg.head_dim)):
        w.add_metadata(f"{arch}.{key}", np.uint32(value))
    w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(cfg.rms_norm_eps))
    w.add_metadata(f"{arch}.rope.freq_base", np.float32(cfg.rope_theta))
    w.add_metadata(f"{arch}.vocab_size", np.uint32(cfg.vocab_size))
    if cfg.bos_token_id is not None:
        w.add_metadata("tokenizer.ggml.bos_token_id", np.uint32(cfg.bos_token_id))
    if cfg.eos_token_ids:
        w.add_metadata("tokenizer.ggml.eos_token_id", np.uint32(cfg.eos_token_ids[0]))
    for key, value in (tokenizer_metadata or {}).items():
        w.add_metadata(key, value)

    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    permute = arch in _PERMUTED_QK_ARCHS

    def put(gguf_name: str, arr: torch.Tensor, layer: int = -1, key: str = ""):
        arr = arr.to(dev)
        t = _pick_type(gguf_name, arr, quant)
        weights = None
        if imatrix is not None and layer >= 0:
            rows = imatrix_rows_for_key(imatrix, key)
            if rows is not None and rows.shape[-1] == arr.shape[-1]:
                weights = torch.from_numpy(np.asarray(rows[layer % len(rows)],
                                                      np.float32)).to(dev)
        w.add_tensor(gguf_name, arr, t, weights)

    put("token_embd.weight", sd[prefix + "embed_tokens.weight"])
    put("output_norm.weight", sd[prefix + "norm.weight"])
    if "lm_head.weight" in sd:
        put("output.weight", sd["lm_head.weight"])
    for i in range(cfg.num_layers):
        lp = f"{prefix}layers.{i}."
        for suffix, key in _HF_TO_KEY.items():
            if lp + suffix not in sd:
                continue
            arr = sd[lp + suffix]
            if permute and key in ("wq", "wk"):
                arr = _permute_rows(arr, cfg.num_heads if key == "wq" else cfg.num_kv_heads)
            put(f"blk.{i}.{_GGUF_NAMES[key]}", arr, layer=i, key=key)
    w.write()
