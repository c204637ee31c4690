"""Model configuration (a copy of ``mistralrs_tpu/models/config.py``).

One normalized dataclass covers the Llama superfamily; the port's decoder
raises ``NotImplementedError`` on the feature fields it does not support yet
(see ``models/llama.py``). :func:`config_from_hf` also refuses, by name, the
HF keys that change the model's function but that the JAX package's reader
drops (:func:`dropped_keys`), so that the port never serves such a
checkpoint as another model."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class ModelConfig:
    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict[str, Any]] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    hidden_act: str = "silu"
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm" (starcoder2)
    sliding_window: Optional[int] = None
    # which layers use sliding window: None → all full attention;
    # "every_other" (gemma2/3), or an explicit per-layer bool list
    layer_types: Optional[list[str]] = None
    logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None  # gemma2/3: query_pre_attn_scalar**-0.5
    rope_local_theta: Optional[float] = None  # gemma3: sliding layers' theta
    embedding_multiplier: Optional[float] = None  # gemma: sqrt(hidden)
    qk_norm: bool = False  # qwen3/gemma3: per-head RMSNorm on q/k
    qk_norm_after_rope: bool = False  # hunyuan: q/k norm applied post-rotary
    # MoE (mixtral/qwen-moe): 0 experts → dense
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = False
    # deepseek-v3-style noaux-tc routing (glm4moe): dense first-k layers,
    # sigmoid scores + correction bias, group-limited top-k, scaled weights
    first_k_dense: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    # smollm3: per-layer rope toggle (1 = apply RoPE, 0 = NoPE layer)
    no_rope_layers: Optional[list[int]] = None
    # phi2/glm: rotate only head_dim * factor leading dims
    partial_rotary_factor: float = 1.0
    # glm family: GPT-J pairing (2j, 2j+1) instead of rotate-half
    rope_interleaved: bool = False
    # phi2: attn and MLP both read the same normed input, one residual add
    parallel_residual: bool = False
    # granite scalar multipliers (None → 1.0)
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    # qwen2moe: always-on shared expert with sigmoid gate
    shared_expert_intermediate_size: Optional[int] = None
    # qwen2-vl M-RoPE: head-dim channel sections fed by the (t, h, w)
    # position streams; () → standard rope. When set, forward_paged accepts
    # rope_positions3 [3, B, T] (mask positions stay the token index).
    mrope_section: tuple[int, ...] = ()
    # qwen3-vl: channel-interleaved [THWTHW...TT] M-RoPE instead of chunked
    mrope_interleaved: bool = False
    # bookkeeping
    bos_token_id: Optional[int] = None
    eos_token_ids: tuple[int, ...] = ()
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# HF "architectures"[0] → arch tag (subset of the reference's 26-entry
# NormalLoaderType registry, normal_loaders.rs:207-231; grows with models/).
HF_ARCH_MAP = {
    "LlamaForCausalLM": "llama",
    "GemmaForCausalLM": "gemma",
    "PhiForCausalLM": "phi2",
    "GlmForCausalLM": "glm",
    "Glm4ForCausalLM": "glm4",
    "GraniteForCausalLM": "granite",
    "Qwen2MoeForCausalLM": "qwen2moe",
    "PhimoeForCausalLM": "phimoe",
    "GptOssForCausalLM": "gpt_oss",
    "HunYuanDenseV1ForCausalLM": "hunyuan",
    "HunYuanMoEV1ForCausalLM": "hunyuan_moe",
    "Glm4MoeForCausalLM": "glm4moe",
    "StableLmForCausalLM": "stablelm",
    "CohereForCausalLM": "cohere",
    "MistralForCausalLM": "mistral",
    "MixtralForCausalLM": "mixtral",
    "Qwen2ForCausalLM": "qwen2",
    "Qwen3ForCausalLM": "qwen3",
    "Qwen3MoeForCausalLM": "qwen3moe",
    "Gemma2ForCausalLM": "gemma2",
    "Gemma3ForCausalLM": "gemma3",
    "Phi3ForCausalLM": "phi3",
    "SmolLM3ForCausalLM": "smollm3",
    "Starcoder2ForCausalLM": "starcoder2",
}


def dropped_keys(cfg: dict[str, Any], arch: str) -> list[str]:
    """The keys of a HF ``config.json`` dict that change the function of an
    ``arch`` model but that JAX ``config_from_hf`` drops, each with what it
    asks for (the published configs of the ten Llama-family variants set
    none of them):

    * cohere's ``use_qk_norm``: HF normalises each head's q and k with a
      LayerNorm of per-head weights; JAX reads it as ``qk_norm`` and applies
      an RMSNorm;
    * stablelm's ``use_parallel_residual`` (JAX's parallel residual is
      phi2's and cohere's alone) and ``qk_layernorm``, phi's
      ``qk_layernorm`` (per-head q/k LayerNorms; JAX maps no such tensor);
    * a LayerNorm arch's ``layer_norm_eps`` (phi2, stablelm, cohere) other
      than the eps JAX reads (``rms_norm_eps`` or ``norm_epsilon``, else
      1e-5)."""
    out = []
    if arch == "cohere" and cfg.get("use_qk_norm"):
        out.append("use_qk_norm (cohere's per-head q/k LayerNorm)")
    if arch == "stablelm" and cfg.get("use_parallel_residual"):
        out.append("use_parallel_residual (stablelm)")
    if arch in ("stablelm", "phi2") and cfg.get("qk_layernorm"):
        out.append(f"qk_layernorm ({arch}'s per-head q/k LayerNorm)")
    eps = cfg.get("rms_norm_eps", cfg.get("norm_epsilon", 1e-5))
    if (arch in ("phi2", "stablelm", "cohere") and "layer_norm_eps" in cfg
            and cfg["layer_norm_eps"] != eps):
        out.append(f"layer_norm_eps {cfg['layer_norm_eps']} (the JAX package reads {eps})")
    return out


def config_from_hf(cfg: dict[str, Any]) -> ModelConfig:
    """Build from a HF ``config.json`` dict (auto-detect like `auto.rs:352`);
    raises ``NotImplementedError`` naming any of :func:`dropped_keys`."""
    archs = cfg.get("architectures") or []
    arch = HF_ARCH_MAP.get(archs[0]) if archs else None
    if arch is None:
        model_type = cfg.get("model_type", "")
        arch = model_type if model_type else "llama"
    n_heads = cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // n_heads
    if arch == "qwen2moe" and (
        cfg.get("mlp_only_layers") or cfg.get("decoder_sparse_step", 1) != 1
    ):
        raise NotImplementedError(
            "qwen2moe: mixed dense/sparse layer stacks not supported yet"
        )
    dropped = dropped_keys(cfg, arch)
    if dropped:
        raise NotImplementedError(f"{arch}: config keys the reference drops: "
                                  f"{', '.join(dropped)}")
    eos = cfg.get("eos_token_id")
    if eos is None:
        eos_ids: tuple[int, ...] = ()
    elif isinstance(eos, int):
        eos_ids = (eos,)
    else:
        eos_ids = tuple(eos)
    return ModelConfig(
        arch=arch,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=n_heads,
        num_kv_heads=cfg.get("num_key_value_heads", n_heads),
        head_dim=head_dim,
        rms_norm_eps=cfg.get("rms_norm_eps", cfg.get("norm_epsilon", 1e-5)),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_scaling=cfg.get("rope_scaling"),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        attention_bias=cfg.get("attention_bias", False),
        mlp_bias=cfg.get("mlp_bias", False),
        hidden_act=cfg.get("hidden_act", cfg.get("hidden_activation", "silu")),
        norm_type=(
            "layernorm" if arch in ("starcoder2", "phi2", "stablelm", "cohere",
                             "phimoe")
            else "rmsnorm"
        ),
        sliding_window=cfg.get("sliding_window"),
        layer_types=cfg.get("layer_types"),
        logit_softcap=cfg.get("final_logit_softcapping"),
        attn_logit_softcap=cfg.get("attn_logit_softcapping"),
        attn_scale=(
            cfg["query_pre_attn_scalar"] ** -0.5
            if cfg.get("query_pre_attn_scalar")
            else cfg.get("attention_multiplier")  # granite
        ),
        embedding_multiplier=cfg.get("embedding_multiplier"),
        residual_multiplier=cfg.get("residual_multiplier"),
        logits_scaling=(
            1.0 / cfg["logit_scale"]  # cohere MULTIPLIES by logit_scale
            if arch == "cohere" and cfg.get("logit_scale")
            else cfg.get("logits_scaling")
        ),
        partial_rotary_factor=cfg.get("partial_rotary_factor", 1.0),
        # glm4moe dropped the interleaved pairing (plain partial rotate-half)
        rope_interleaved=arch in ("glm", "glm4", "cohere"),
        parallel_residual=arch in ("phi2", "cohere"),
        shared_expert_intermediate_size=cfg.get("shared_expert_intermediate_size"),
        rope_local_theta=cfg.get("rope_local_base_freq"),
        qk_norm=(
            arch in ("qwen3", "qwen3moe", "gemma3", "hunyuan", "hunyuan_moe")
            or bool(cfg.get("use_qk_norm"))  # glm4moe
        ),
        qk_norm_after_rope=arch in ("hunyuan", "hunyuan_moe"),
        num_experts=cfg.get(
            "num_local_experts",
            cfg.get("num_experts", cfg.get("n_routed_experts", 0)),
        ) or 0,
        first_k_dense=cfg.get("first_k_dense_replace", 0) or 0,
        n_group=cfg.get("n_group", 1) or 1,
        topk_group=cfg.get("topk_group", 1) or 1,
        routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0) or 1.0,
        num_experts_per_tok=cfg.get(
            "num_experts_per_tok", cfg.get("moe_topk", 0)  # hunyuan_moe
        ) or 0,
        moe_intermediate_size=cfg.get("moe_intermediate_size"),
        norm_topk_prob=cfg.get("norm_topk_prob", False),
        no_rope_layers=cfg.get("no_rope_layers"),
        bos_token_id=cfg.get("bos_token_id"),
        eos_token_ids=eos_ids,
    )


def config_from_gguf(md: dict[str, Any]) -> ModelConfig:
    """Build from GGUF metadata (keys per the GGUF spec, `<arch>.` prefixed)."""
    arch = md["general.architecture"]

    def g(key: str, default=None):
        return md.get(f"{arch}.{key}", default)

    n_heads = g("attention.head_count")
    hidden = g("embedding_length")
    head_dim = g("attention.key_length") or hidden // n_heads
    n_vocab = md.get("tokenizer.ggml.tokens")
    vocab_size = g("vocab_size") or (len(n_vocab) if n_vocab is not None else None)
    eos = md.get("tokenizer.ggml.eos_token_id")
    return ModelConfig(
        arch=arch,
        vocab_size=vocab_size,
        hidden_size=hidden,
        intermediate_size=g("feed_forward_length"),
        num_layers=g("block_count"),
        num_heads=n_heads,
        num_kv_heads=g("attention.head_count_kv", n_heads),
        head_dim=head_dim,
        rms_norm_eps=g("attention.layer_norm_rms_epsilon", 1e-5),
        rope_theta=g("rope.freq_base", 10000.0),
        max_position_embeddings=g("context_length", 4096),
        sliding_window=g("attention.sliding_window"),
        num_experts=g("expert_count", 0) or 0,
        num_experts_per_tok=g("expert_used_count", 0) or 0,
        moe_intermediate_size=g("expert_feed_forward_length"),
        qk_norm=arch in ("qwen3", "qwen3moe", "gemma3") or arch.startswith("hunyuan"),
        qk_norm_after_rope=arch.startswith("hunyuan"),
        bos_token_id=md.get("tokenizer.ggml.bos_token_id"),
        eos_token_ids=(eos,) if eos is not None else (),
    )


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window sizes [L] (0 = full attention): a copy of
    JAX ``models/llama.py::layer_windows``. ``layer_types`` names the
    sliding layers where the config has it; else gemma2 slides on its even
    layers, gemma3 on all but every sixth, any other arch on every layer."""
    out = np.zeros(cfg.num_layers, dtype=np.int32)
    if cfg.sliding_window:
        if cfg.layer_types:
            for i, lt in enumerate(cfg.layer_types):
                if lt == "sliding_attention":
                    out[i] = cfg.sliding_window
        elif cfg.arch in ("gemma2", "gemma3"):
            for i in range(cfg.num_layers):
                if (i % 2 == 0) if cfg.arch == "gemma2" else ((i + 1) % 6 != 0):
                    out[i] = cfg.sliding_window
        else:  # mistral-style: uniform sliding window
            out[:] = cfg.sliding_window
    return out


def layer_rope_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer RoPE flags [L] (0: a NoPE layer, SmolLM3's every fourth): a
    copy of JAX ``models/llama.py::layer_rope_flags``."""
    if cfg.no_rope_layers:
        return np.asarray(cfg.no_rope_layers, np.int32)
    return np.ones(cfg.num_layers, dtype=np.int32)
