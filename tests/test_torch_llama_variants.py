"""The Llama-family variants in the port, on the CPU, each held against the
JAX package: phi2, phi3, starcoder2, stablelm, cohere, granite, glm, glm4,
smollm3 and hunyuan (dense).

* The pieces, f32 within 1e-6: ``layer_norm`` with and without a bias,
  ``apply_rope`` partial (rotated dims 6, 16, 32 of 64) and interleaved,
  ``rope_sets`` at partial factors, ``layer_rope_flags`` (NoPE layers),
  ``fuse_projections`` on biased and gateless MLPs (which parts fuse).
* ``config_from_hf`` on the published ``config.json`` of Phi-3-mini-4k,
  Phi-2, StarCoder2-7B, StableLM-2-1.6B, Aya-23-8B, Granite-3.1-8B,
  glm-4-9b-chat-hf, GLM-4-9B-0414 and SmolLM3-3B: both packages' configs
  equal field for field, none refused by the port's decoder; the keys that
  the JAX reader drops although they change the function refused by name
  (cohere's ``use_qk_norm``, stablelm's ``use_parallel_residual`` and
  ``qk_layernorm``, phi's ``qk_layernorm``, a LayerNorm arch's
  ``layer_norm_eps`` the JAX reader does not read), and a gated MLP's
  biases, which the JAX loader drops, refused by the port's loader.
* Tiny HF directories of each arch, whose config and tensor names come
  from ``transformers``' own classes and whose values are drawn with numpy
  (test-side only): both loaders give equal weights (after
  ``from_jax_params``), and ``forward_paged``'s f32 logits on a prefill
  chunk and a decode step agree with JAX ``forward_paged``
  (``backend="xla"``) within 1e-4 of the largest. For phi2 and phi3 the
  engines' greedy tokens are identical; for phi2 ``cli serve --isq q4_k``
  reaches the engine with Q4_K layers and dense biases.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models import llama as jax_llama
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.ops.norms import layer_norm as jax_layer_norm
from mistralrs_tpu.ops.rope import apply_rope as jax_apply_rope
from mistralrs_tpu_torch import cli
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models import hf_loader
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import (
    check_supported,
    forward_paged,
    fuse_projections,
    layer_rope_flags,
    rope_sets,
)
from mistralrs_tpu_torch.ops.norms import layer_norm
from mistralrs_tpu_torch.ops.rope import apply_rope
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant.qtensor import QTensor
from mistralrs_tpu_torch.serving.server import Server

from test_torch_deepseek import write_safetensors
from test_torch_gemma2 import _tree_equal
from test_torch_llama import jax_to_numpy
from test_torch_qwen import _steps

# ---------------------------------------------------------------------------
# the published config.json files (huggingface.co/<repo>/config.json)
# ---------------------------------------------------------------------------

PUBLISHED = {
    # microsoft/Phi-3-mini-4k-instruct
    "phi3": {
        "architectures": ["Phi3ForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1,
        "embd_pdrop": 0.0, "eos_token_id": 32000, "hidden_act": "silu", "hidden_size": 3072,
        "initializer_range": 0.02, "intermediate_size": 8192, "max_position_embeddings": 4096,
        "model_type": "phi3", "num_attention_heads": 32, "num_hidden_layers": 32,
        "num_key_value_heads": 32, "original_max_position_embeddings": 4096,
        "pad_token_id": 32000, "resid_pdrop": 0.0, "rms_norm_eps": 1e-05, "rope_scaling": None,
        "rope_theta": 10000.0, "sliding_window": 2047, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "use_cache": True, "attention_bias": False,
        "vocab_size": 32064},
    # microsoft/phi-2
    "phi2": {
        "architectures": ["PhiForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 50256,
        "embd_pdrop": 0.0, "eos_token_id": 50256, "hidden_act": "gelu_new", "hidden_size": 2560,
        "initializer_range": 0.02, "intermediate_size": 10240, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 2048, "model_type": "phi", "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 32, "partial_rotary_factor": 0.4,
        "qk_layernorm": False, "resid_pdrop": 0.1, "rope_scaling": None, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
        "vocab_size": 51200},
    # bigcode/starcoder2-7b
    "starcoder2": {
        "architectures": ["Starcoder2ForCausalLM"], "attention_dropout": 0.1,
        "residual_dropout": 0.1, "embedding_dropout": 0.1, "bos_token_id": 0, "eos_token_id": 0,
        "hidden_act": "gelu_pytorch_tanh", "hidden_size": 4608, "initializer_range": 0.018042,
        "intermediate_size": 18432, "max_position_embeddings": 16384, "mlp_type": "default",
        "model_type": "starcoder2", "norm_epsilon": 1e-05, "norm_type": "layer_norm",
        "num_attention_heads": 36, "num_hidden_layers": 32, "num_key_value_heads": 4,
        "rope_theta": 1000000, "sliding_window": 4096, "torch_dtype": "bfloat16",
        "use_bias": True, "use_cache": True, "vocab_size": 49152},
    # stabilityai/stablelm-2-1_6b
    "stablelm": {
        "architectures": ["StableLmForCausalLM"], "bos_token_id": 100257,
        "eos_token_id": 100257, "hidden_act": "silu", "hidden_size": 2048,
        "initializer_range": 0.02, "intermediate_size": 5632, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 4096, "model_type": "stablelm", "num_attention_heads": 32,
        "num_hidden_layers": 24, "num_key_value_heads": 32, "partial_rotary_factor": 0.25,
        "rope_theta": 10000, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "use_qkv_bias": True, "vocab_size": 100352},
    # CohereForAI/aya-23-8B
    "cohere": {
        "architectures": ["CohereForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 5, "eos_token_id": 255001,
        "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 14336, "layer_norm_eps": 1e-05, "logit_scale": 0.125,
        "max_position_embeddings": 8192, "model_type": "cohere", "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8, "pad_token_id": 0,
        "rope_theta": 10000, "torch_dtype": "float16", "use_cache": True, "use_qk_norm": False,
        "vocab_size": 256000},
    # ibm-granite/granite-3.1-8b-instruct
    "granite": {
        "architectures": ["GraniteForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.1, "attention_multiplier": 0.0078125, "bos_token_id": 0,
        "embedding_multiplier": 12.0, "eos_token_id": 0, "hidden_act": "silu",
        "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 12800,
        "logits_scaling": 16.0, "max_position_embeddings": 131072, "mlp_bias": False,
        "model_type": "granite", "num_attention_heads": 32, "num_hidden_layers": 40,
        "num_key_value_heads": 8, "pad_token_id": 0, "residual_multiplier": 0.22,
        "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000000.0,
        "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True,
        "vocab_size": 49155},
    # THUDM/glm-4-9b-chat-hf
    "glm": {
        "architectures": ["GlmForCausalLM"], "attention_bias": True, "attention_dropout": 0.0,
        "eos_token_id": [151329, 151336, 151338], "head_dim": 128, "hidden_act": "silu",
        "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 13696,
        "max_position_embeddings": 131072, "model_type": "glm", "num_attention_heads": 32,
        "num_hidden_layers": 40, "num_key_value_heads": 2, "pad_token_id": 151329,
        "partial_rotary_factor": 0.5, "rms_norm_eps": 1.5625e-07, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
        "vocab_size": 151552},
    # THUDM/GLM-4-9B-0414
    "glm4": {
        "architectures": ["Glm4ForCausalLM"], "attention_bias": True, "attention_dropout": 0.0,
        "eos_token_id": [151329, 151336, 151338], "head_dim": 128, "hidden_act": "silu",
        "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 13696,
        "max_position_embeddings": 32768, "model_type": "glm4", "num_attention_heads": 32,
        "num_hidden_layers": 40, "num_key_value_heads": 2, "pad_token_id": 151329,
        "partial_rotary_factor": 0.5, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
        "vocab_size": 151552},
    # HuggingFaceTB/SmolLM3-3B
    "smollm3": {
        "architectures": ["SmolLM3ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": None, "eos_token_id": 128012,
        "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
        "intermediate_size": 11008, "max_position_embeddings": 65536, "max_window_layers": 28,
        "mlp_bias": False, "model_type": "smollm3", "no_rope_layer_interval": 4,
        "no_rope_layers": [0 if (i + 1) % 4 == 0 else 1 for i in range(36)],
        "num_attention_heads": 16, "num_hidden_layers": 36, "num_key_value_heads": 4,
        "pad_token_id": 128004, "pretraining_tp": 2, "rms_norm_eps": 1e-06,
        "rope_scaling": None, "rope_theta": 5000000.0, "sliding_window": None,
        "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": False,
        "use_sliding_window": False, "vocab_size": 128256},
}

# ---------------------------------------------------------------------------
# the pieces against their JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm_matches_jax(bias):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32) if bias else None
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                         1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rot", [6, 16, 32, 64])
def test_apply_rope_partial_interleaved_matches_jax(rot, interleaved):
    """x [2, 7, 4 heads, 64]; the leading ``rot`` dims rotated, the rest
    passed through (bit for bit)."""
    rng = np.random.default_rng(rot)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    ang = rng.standard_normal((2, 7, rot // 2)).astype(np.float32) * 3
    cos, sin = np.cos(ang), np.sin(ang)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                     interleaved=interleaved).numpy()
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                                    interleaved=interleaved))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


@pytest.mark.parametrize("kind", ["phi2", "stablelm", "glm4", "phi3"])
def test_rope_sets_match_jax(kind):
    """The rotated width ``int(head_dim * partial_rotary_factor)`` (Phi-2's
    32 of 80, StableLM's 16 of 64, GLM-4's 64 of 128, Phi-3's whole 96), at
    positions up to 300 (at thousands XLA's and torch's f32 cos of the same
    angle can part by an ulp of the angle's magnitude)."""
    cfg = config_from_hf(PUBLISHED[kind])
    pos = np.array([[0, 5, 300], [17, 1, 2]], np.int32)
    (cos, sin), local = rope_sets(cfg, torch.from_numpy(pos).long())
    jc, js, _, _ = jax_llama._rope_sets(jax_config_from_hf(PUBLISHED[kind]), jnp.asarray(pos))
    assert cos.shape[-1] == int(cfg.head_dim * cfg.partial_rotary_factor) // 2
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=1e-6)
    assert local[0] is cos


def test_layer_rope_flags_match_jax():
    for kind in ("smollm3", "phi3"):
        cfg, jcfg = config_from_hf(PUBLISHED[kind]), jax_config_from_hf(PUBLISHED[kind])
        np.testing.assert_array_equal(layer_rope_flags(cfg), jax_llama.layer_rope_flags(jcfg))
    assert layer_rope_flags(config_from_hf(PUBLISHED["smollm3"])).tolist()[:8] == [
        1, 1, 1, 0, 1, 1, 1, 0]


@pytest.mark.parametrize("mlp", ["gated", "gated_biased", "gateless"])
def test_fuse_projections_matches_jax(mlp):
    """Which MLP parts fuse: a gated MLP's gate and up into ``wgateup``; not
    when they carry biases, and not a gateless MLP's up (JAX
    ``fuse_projections`` on the same layer's stacked leaves)."""
    rng = np.random.default_rng(3)
    layer = {"up": rng.standard_normal((1, 8, 4)), "down": rng.standard_normal((1, 4, 8))}
    if mlp != "gateless":
        layer["gate"] = rng.standard_normal((1, 8, 4))
    if mlp == "gated_biased":
        layer["gate_bias"] = rng.standard_normal((1, 8))
        layer["up_bias"] = rng.standard_normal((1, 8))
    cfg = ModelConfig(arch="llama", vocab_size=8, hidden_size=4, intermediate_size=8,
                      num_layers=1, num_heads=1, num_kv_heads=1, head_dim=4)
    ours = fuse_projections({"layers": [{k: torch.from_numpy(v[0]) for k, v in layer.items()}]},
                            cfg)["layers"][0]
    theirs = jax_llama.fuse_projections(
        {"layers": {k: jnp.asarray(v, jnp.float32) for k, v in layer.items()}}, cfg)["layers"]
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(theirs[k])[0], atol=1e-6)


# ---------------------------------------------------------------------------
# configs and refusals
# ---------------------------------------------------------------------------


def test_published_configs_match_jax():
    for kind, d in PUBLISHED.items():
        cfg = config_from_hf(d)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config_from_hf(d)), kind
        check_supported(cfg)
    phi2, phi3 = config_from_hf(PUBLISHED["phi2"]), config_from_hf(PUBLISHED["phi3"])
    assert (phi2.head_dim, phi2.norm_type, phi2.parallel_residual) == (80, "layernorm", True)
    assert (phi3.head_dim, phi3.sliding_window) == (96, 2047)
    assert config_from_hf(PUBLISHED["cohere"]).logits_scaling == 8.0
    assert config_from_hf(PUBLISHED["glm4"]).rope_interleaved


@pytest.mark.parametrize("kind,key,value,name", [
    ("cohere", "use_qk_norm", True, "use_qk_norm"),
    ("stablelm", "use_parallel_residual", True, "use_parallel_residual"),
    ("stablelm", "qk_layernorm", True, "qk_layernorm"),
    ("phi2", "qk_layernorm", True, "qk_layernorm"),
    ("phi2", "layer_norm_eps", 1e-6, "layer_norm_eps"),
])
def test_dropped_keys_refused(kind, key, value, name):
    """A key the JAX reader drops although it changes the function: the JAX
    config takes it silently, the port refuses it by name."""
    d = dict(PUBLISHED[kind], **{key: value})
    jax_config_from_hf(d)
    with pytest.raises(NotImplementedError, match=name):
        config_from_hf(d)


def test_gated_mlp_biases_refused():
    """Granite with ``mlp_bias``: the JAX loader maps no ``mlp.*_proj.bias``
    (it drops them); the port refuses the config key, and its loader names
    such a tensor."""
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        check_supported(config_from_hf(dict(PUBLISHED["granite"], mlp_bias=True)))
    cfg = ModelConfig(arch="granite", vocab_size=8, hidden_size=4, intermediate_size=8,
                      num_layers=1, num_heads=1, num_kv_heads=1, head_dim=4)
    sd = {"model.embed_tokens.weight": torch.zeros(8, 4), "model.norm.weight": torch.ones(4),
          "model.layers.0.mlp.gate_proj.bias": torch.zeros(8)}
    with pytest.raises(NotImplementedError, match="mlp.gate_proj.bias"):
        hf_loader.weights_from_state_dict(sd, cfg, device="cpu")


# ---------------------------------------------------------------------------
# tiny HF directories against the JAX package
# ---------------------------------------------------------------------------

COMMON = dict(vocab_size=128, num_hidden_layers=2, max_position_embeddings=128, hidden_size=64,
              intermediate_size=96, num_attention_heads=4)
IDS = dict(pad_token_id=0, bos_token_id=1, eos_token_id=2)
TINY = {
    "phi2": ("PhiConfig", "PhiForCausalLM", dict(
        num_key_value_heads=4, partial_rotary_factor=0.4, hidden_act="gelu_new")),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(num_key_value_heads=2, sliding_window=12,
                                                  **IDS)),
    "starcoder2": ("Starcoder2Config", "Starcoder2ForCausalLM", dict(
        num_key_value_heads=1, use_bias=True, sliding_window=12)),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM", dict(
        num_key_value_heads=4, use_qkv_bias=True, partial_rotary_factor=0.25)),
    "cohere": ("CohereConfig", "CohereForCausalLM", dict(num_key_value_heads=2,
                                                         logit_scale=0.125, **IDS)),
    "granite": ("GraniteConfig", "GraniteForCausalLM", dict(
        num_key_value_heads=2, embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.125, logits_scaling=16.0, tie_word_embeddings=True)),
    "glm": ("GlmConfig", "GlmForCausalLM", dict(num_key_value_heads=2, head_dim=16,
                                                partial_rotary_factor=0.5, **IDS)),
    "glm4": ("Glm4Config", "Glm4ForCausalLM", dict(num_key_value_heads=1, head_dim=16,
                                                   partial_rotary_factor=0.5, **IDS)),
    "smollm3": ("SmolLM3Config", "SmolLM3ForCausalLM", dict(
        num_key_value_heads=2, no_rope_layers=[1, 0], tie_word_embeddings=True, **IDS)),
    "hunyuan": ("HunYuanDenseV1Config", "HunYuanDenseV1ForCausalLM", dict(
        num_key_value_heads=2, head_dim=16, **IDS)),
}


@pytest.fixture(scope="module")
def layouts():
    """Each tiny case's HF ``config.json`` dict and its tensors' names and
    shapes, from ``transformers``' own classes (a tied head's
    ``lm_head.weight`` left out, as ``save_pretrained`` writes it)."""
    os.environ.setdefault("USE_TF", "0")  # transformers need not import TensorFlow
    transformers = pytest.importorskip("transformers")
    out = {}
    for kind, (cfg_cls, model_cls, kw) in TINY.items():
        hf_cfg = getattr(transformers, cfg_cls)(**COMMON, **{"tie_word_embeddings": False, **kw})
        model = getattr(transformers, model_cls)(hf_cfg)
        d = hf_cfg.to_dict() | {"architectures": [model_cls]}
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
                  if not (d["tie_word_embeddings"] and k == "lm_head.weight")}
        out[kind] = (d, shapes)
    return out


def _write_dir(path, layout, seed, **config):
    """The tiny checkpoint: every tensor drawn from numpy (norm weights 1 +
    N(0, 0.1^2), the rest N(0, 0.1^2))."""
    cfg_d, shapes = layout
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32)
        a = 1 + 0.1 * a if "norm" in name and name.endswith("weight") else 0.1 * a
        sd[name] = a
    (path / "config.json").write_text(json.dumps(cfg_d | config))
    write_safetensors(path / "model.safetensors", sd)


# the arch's own leaves (after the HF loader, before fusion)
FEATURES = {
    "phi2": {"attn_norm_bias", "up_bias", "down_bias", "wo_bias", "wq_bias"},
    "phi3": {"gate", "up", "wq"},
    "starcoder2": {"attn_norm_bias", "ffn_norm_bias", "up_bias", "down_bias", "wo_bias"},
    "stablelm": {"attn_norm_bias", "ffn_norm_bias", "wq_bias"},
    "cohere": {"attn_norm"},
    "granite": {"gate"},
    "glm": {"gate", "wq_bias"},
    "glm4": {"post_attn_norm", "post_ffn_norm", "wq_bias"},
    "smollm3": {"gate"},
    "hunyuan": {"q_norm", "k_norm"},
}


@pytest.mark.parametrize("kind", list(TINY))
def test_hf_dir_matches_jax(tmp_path, layouts, kind):
    """Both loaders on the tiny directory: the port's weights equal the JAX
    loader's carried across (exactly); f32 ``forward_paged`` logits on a
    prefill chunk (2 rows of 20 and 14 tokens, past the 12-token windows)
    and a decode step within 1e-4 of the largest of JAX's
    (``backend="xla"``)."""
    _write_dir(tmp_path, layouts[kind], seed=len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert pipe.adapter is None and cfg.arch == jcfg.arch == kind
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _tree_equal(pipe.weights, carried)
    assert FEATURES[kind] <= set(pipe.weights["layers"][0])
    assert ("gate" in pipe.weights["layers"][0]) == (kind not in ("phi2", "starcoder2"))
    assert ("final_norm_bias" in pipe.weights) == (kind in ("phi2", "starcoder2", "stablelm"))
    assert ("lm_head_bias" in pipe.weights) == (kind == "phi2")
    weights = fuse_projections(pipe.weights, cfg)
    bs, w = 8, 8
    bt, steps = _steps((20, 14), 20, 1, bs, w, seed=3)
    tc = PagedKVCache.create(cfg, 2 * w, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, 2 * w, bs, dtype=jnp.float32)
    for i, (ids, pos, slots, kv_lens, last) in enumerate(steps):
        decode = ids.shape[1] == 1
        jl, jc = jax_llama.forward_paged(
            jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(kv_lens), block_size=bs, backend="xla",
            compute_dtype=jnp.float32, last_indices=None if decode else jnp.asarray(last))
        tl, tc = forward_paged(weights, cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(pos).long(), tc, torch.from_numpy(bt),
                               torch.from_numpy(slots), torch.from_numpy(kv_lens),
                               block_size=bs, compute_dtype=torch.float32,
                               last_indices=None if decode else torch.from_numpy(last))
        jl = np.asarray(jl)
        err = np.abs(tl.numpy() - jl).max()
        assert err <= 1e-4 * np.abs(jl).max(), f"{kind} step {i}: {err}"


@pytest.mark.parametrize("kind", ["phi2", "phi3"])
def test_engine_greedy_matches_jax(tmp_path, layouts, kind):
    """f32 engines on the tiny directory: a 20-token and a 13-token prompt in
    8-token chunks (past phi3's 12-token window), 5 greedy tokens each."""
    _write_dir(tmp_path, layouts[kind], seed=10 + len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg), compute_dtype=torch.float32,
                device="cpu", **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 128, n).tolist() for n in (20, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=5)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=5)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 5 for s in ts)


def test_cli_serve_isq_phi2(tmp_path, monkeypatch):
    """``cli serve DIR --isq q4_k`` on a Phi-2 directory of hidden 256
    (K = 256 and 512: every projection on Q4_K, the embedding and head on
    Q8_0): the engine holds the planes, the biases and LayerNorms stay
    dense (q/k/v fused with their biases); the server is stopped where it
    would start serving. The quantizers' many small torch ops run on one
    thread, as in ``tests/test_torch_isq.py`` (beside the suite's other
    workers an intra-op pool made them crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _serve_isq_phi2(tmp_path, monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _serve_isq_phi2(tmp_path, monkeypatch):
    tokenizers = pytest.importorskip("tokenizers")
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.PhiConfig(vocab_size=128, num_hidden_layers=1, hidden_size=256,
                                    intermediate_size=512, num_attention_heads=4,
                                    num_key_value_heads=4, partial_rotary_factor=0.4,
                                    max_position_embeddings=128, tie_word_embeddings=False)
    model = transformers.PhiForCausalLM(hf_cfg)
    layout = (hf_cfg.to_dict() | {"architectures": ["PhiForCausalLM"]},
              {k: tuple(v.shape) for k, v in model.state_dict().items()})
    _write_dir(tmp_path, layout, seed=4, eos_token_id=1)
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel({f"w{i}": i for i in range(128)},
                                                           unk_token="w0"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    seen = {}

    def stop(self):
        seen["weights"] = self.resolve(None).engine.weights
        self.shutdown()
        raise KeyboardInterrupt

    monkeypatch.setattr(Server, "serve_forever", stop)
    assert cli.main(["serve", str(tmp_path), "--isq", "q4_k", "--device", "cpu", "--host",
                     "127.0.0.1", "--port", "0", "--max-seq-len", "64"]) == 0
    w = seen["weights"]
    lw = w["layers"][0]
    assert w["embed"].ggml_type == w["lm_head"].ggml_type == GGMLType.Q8_0
    for key in ("wqkv", "wo", "up", "down"):
        assert isinstance(lw[key], QTensor) and lw[key].ggml_type == GGMLType.Q4_K, key
    for key in ("wqkv_bias", "wo_bias", "up_bias", "down_bias", "attn_norm", "attn_norm_bias"):
        assert isinstance(lw[key], torch.Tensor), key
    assert isinstance(w["lm_head_bias"], torch.Tensor) and "final_norm_bias" in w
