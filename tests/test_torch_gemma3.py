"""Gemma-3 text (``Gemma3ForCausalLM``) in the port, on the CPU, held against
the JAX package: its two rope sets (the global one with linear scaling, a
local base for the sliding layers), the q/k norms in the gemma form, the
HF directory, the engine over bf16, int8 and fp8 pools, and what stays
refused.

* The configs of Gemma-3-12B and -27B (the ``text_config`` of their
  published ``config.json``, with ``Gemma3TextConfig``'s defaults filled
  in, as a ``Gemma3ForCausalLM`` directory holds them): equal in both
  packages, with their windows, rope bases, scaling and scales.
* Linear rope scaling against JAX ``rope_frequencies`` (within 1e-6
  relative: XLA's CPU ``pow`` is at times an ulp off torch's, scaling or
  not), and exactly the unscaled frequencies over the factor.
* ``forward_paged`` on a tiny 6-layer Gemma-3 (layers 0-4 sliding with a
  window of 8, layer 5 full; q/k norms and post norms not ones; linear
  scaling 8 on the global set, local base 10^4) against JAX
  ``forward_paged(backend="xla")`` over 8-token chunks that cross the
  window and 6 decode steps: f32 rtol/atol 1e-4. Controls: the model with
  its local base dropped, and with its scaling dropped, each moves the
  logits by more than 1e-2.
* An HF directory written as safetensors: ``load_pipeline`` gives the
  weights of JAX ``load_hf_model`` → ``from_jax_params`` exactly and the
  same logits (atol 1e-4, f32) across the window; its chat template (the
  directory's own, else the gemma fallback); ``cli serve DIR --kv-quant
  int8`` answers a chat request.
* The engines' greedy tokens (f32): over bf16 pools the port's equal the
  JAX engine's (``backend="xla"``). Over int8 and fp8 pools the two
  packages read a prefill chunk's own rows differently: the port as the
  JAX prefill kernel does, ``bf16(code x s)`` with the f32 scale, the JAX
  XLA path as ``code x bf16(s)`` from the pool; an fp8 run can part the
  two at a near-tie. So those runs take the XLA path's reading in the
  port (``paged_attention.chunk_round_trip`` patched), and must then give
  the JAX engine's tokens exactly; the chunk's own reading is held against
  the JAX prefill kernel in ``tests/test_torch_kv_quant_options.py``.
* ``Gemma3ForConditionalGeneration`` (with its vision tower) is refused by
  name.
"""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.models.llama import layer_windows as jax_layer_windows
from mistralrs_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import forward_paged, init_random_weights, layer_windows
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.rope import rope_frequencies
from mistralrs_tpu_torch.pipeline import load_pipeline

from test_torch_deepseek import write_safetensors
from test_torch_gemma2 import _gemma_steps, _tree_equal, _write_hf
from test_torch_kv_quant_options import engines_agree, xla_chunk_reading
from test_torch_llama import jax_to_numpy

# ---------------------------------------------------------------------------
# configs and rope
# ---------------------------------------------------------------------------

# Gemma3TextConfig's defaults (transformers), which the published text_config
# entries leave out
_TEXT_DEFAULTS = dict(
    architectures=["Gemma3ForCausalLM"], model_type="gemma3_text", vocab_size=262208,
    head_dim=256, query_pre_attn_scalar=256, rope_theta=1000000.0,
    rope_local_base_freq=10000.0, rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
    max_position_embeddings=131072, sliding_window_pattern=6, final_logit_softcapping=None,
    attn_logit_softcapping=None, attention_bias=False, tie_word_embeddings=True,
    bos_token_id=2, eos_token_id=1,
)
# the text_config entries of google/gemma-3-12b-it's and -27b-it's config.json
PUBLISHED = {
    "12b": dict(hidden_size=3840, intermediate_size=15360, num_attention_heads=16,
                num_hidden_layers=48, num_key_value_heads=8, sliding_window=1024,
                rope_scaling={"factor": 8.0, "rope_type": "linear"}),
    "27b": dict(hidden_size=5376, intermediate_size=21504, num_attention_heads=32,
                num_hidden_layers=62, num_key_value_heads=16, head_dim=128,
                query_pre_attn_scalar=168, sliding_window=1024,
                rope_scaling={"factor": 8.0, "rope_type": "linear"}),
}


@pytest.mark.parametrize("size", ["12b", "27b"])
def test_published_configs_parse(size):
    d = dict(_TEXT_DEFAULTS, **PUBLISHED[size])
    cfg, jcfg = config_from_hf(d), jax_config_from_hf(d)
    assert vars(cfg) == vars(jcfg)
    assert cfg.arch == "gemma3" and cfg.qk_norm and cfg.tie_word_embeddings
    assert cfg.rope_local_theta == 1e4 and cfg.rope_theta == 1e6
    assert cfg.rope_scaling == {"factor": 8.0, "rope_type": "linear"}
    assert cfg.hidden_act == "gelu_pytorch_tanh" and cfg.attn_logit_softcap is None
    assert cfg.attn_scale == d["query_pre_attn_scalar"] ** -0.5
    assert cfg.head_dim == d["head_dim"]
    windows = layer_windows(cfg)
    np.testing.assert_array_equal(windows, jax_layer_windows(jcfg))
    assert windows.tolist()[:6] == [1024] * 5 + [0]
    assert (windows == 0).sum() == cfg.num_layers // 6


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 8.0},
                                     {"type": "linear", "factor": 2.5}])
def test_linear_rope_matches_jax(scaling):
    for hd, theta in ((256, 1e6), (128, 1e4), (16, 1e4)):
        got = rope_frequencies(hd, theta, scaling).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_rope_frequencies(hd, theta, scaling)),
                                   rtol=1e-6, atol=0)
    if scaling:
        base = rope_frequencies(64, 1e6, None)
        torch.testing.assert_close(rope_frequencies(64, 1e6, scaling),
                                   base / scaling["factor"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# forward_paged
# ---------------------------------------------------------------------------

GEMMA3_KW = dict(
    arch="gemma3", vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=6,
    num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=8, attn_scale=24 ** -0.5,
    rms_norm_eps=1e-6, rope_theta=1e6, rope_local_theta=1e4, qk_norm=True,
    rope_scaling={"rope_type": "linear", "factor": 8.0}, hidden_act="gelu_pytorch_tanh",
    tie_word_embeddings=True, max_position_embeddings=256,
)


def _gemma3_weights(jcfg, seed, jdt):
    """JAX random weights with post norms and q/k norms that are not ones
    (gemma norms: stored as w - 1, applied as 1 + w)."""
    jw = jax_init(jcfg, seed=seed, dtype=jdt, scale=0.1)
    rng = np.random.default_rng(seed + 100)
    layers = dict(jw["layers"])
    for key, width in (("post_attn_norm", jcfg.hidden_size), ("post_ffn_norm", jcfg.hidden_size),
                       ("q_norm", jcfg.head_dim), ("k_norm", jcfg.head_dim)):
        layers[key] = jnp.asarray(rng.standard_normal((jcfg.num_layers, width)) * 0.2, jdt)
    return dict(jw, layers=layers)


def _run_port(tw, cfg, steps, bt, bs, kv_quant=None):
    tc = PagedKVCache.create(cfg, 9, bs, dtype=torch.float32, kv_quant=kv_quant, device="cpu")
    out = []
    for ids, pos, slots, kv_lens, last in steps:
        tl, tc = forward_paged(tw, cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(pos).long(), tc, torch.from_numpy(bt),
                               torch.from_numpy(slots), torch.from_numpy(kv_lens),
                               block_size=bs, compute_dtype=torch.float32,
                               last_indices=None if last is None else torch.from_numpy(last))
        out.append(tl.numpy())
    return out


def test_gemma3_forward_paged_matches_jax():
    jcfg, cfg = JaxConfig(**GEMMA3_KW), ModelConfig(**GEMMA3_KW)
    jw = _gemma3_weights(jcfg, 3, jnp.float32)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    assert layer_windows(cfg).tolist() == [8] * 5 + [0]
    assert {"q_norm", "k_norm", "post_attn_norm"} <= set(tw["layers"][0])
    bt, bs, steps = _gemma_steps()
    jc = JaxCache.create(jcfg, 9, bs, dtype=jnp.float32)
    reset_counts()
    got = _run_port(tw, cfg, steps, bt, bs)
    assert COUNTS["paged_prefill_plain"] == 3 * 6 and COUNTS["paged_decode_plain"] == 6 * 6
    for tl, (ids, pos, slots, kv_lens, last) in zip(got, steps):
        jl, jc = jax_forward(jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
                             jnp.asarray(slots), jnp.asarray(kv_lens), block_size=bs,
                             backend="xla", compute_dtype=jnp.float32,
                             last_indices=None if last is None else jnp.asarray(last))
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4, atol=1e-4)
    # controls: each rope feature moves the logits
    for what, change in (("local base", dict(rope_local_theta=None)),
                         ("linear scaling", dict(rope_scaling=None))):
        other = _run_port(tw, ModelConfig(**dict(GEMMA3_KW, **change)), steps, bt, bs)
        moved = max(np.abs(a - b).max() for a, b in zip(got, other))
        assert moved > 1e-2, (what, moved)


def test_init_random_weights_match_jax():
    """The port's random Gemma-3 weights are the JAX function's (q/k norms
    of ones [head_dim], applied in the gemma form)."""
    cfg, jcfg = ModelConfig(**GEMMA3_KW), JaxConfig(**GEMMA3_KW)
    tw = init_random_weights(cfg, seed=2, dtype=torch.float32, device="cpu")
    carried = from_jax_params(jax_to_numpy(jax_init(jcfg, seed=2, dtype=jnp.float32)), cfg,
                              device="cpu", dtype=torch.float32)
    _tree_equal(tw, carried)
    assert tw["layers"][0]["q_norm"].shape == (cfg.head_dim,)


# ---------------------------------------------------------------------------
# the HF directory, the chat template and the CLI
# ---------------------------------------------------------------------------


def _hf_gemma3(rng, n_layers=6):
    """(config.json dict, f32 state dict) of a tiny Gemma3ForCausalLM
    directory: layer types given as the config's list, window 4."""
    h, i, v, nh, nkv, hd = 32, 64, 128, 4, 2, 16
    cfg = dict(_TEXT_DEFAULTS, vocab_size=v, hidden_size=h, intermediate_size=i,
               num_hidden_layers=n_layers, num_attention_heads=nh, num_key_value_heads=nkv,
               head_dim=hd, query_pre_attn_scalar=hd, sliding_window=4,
               max_position_embeddings=128, rope_scaling={"rope_type": "linear", "factor": 8.0},
               layer_types=["sliding_attention"] * 5 + ["full_attention"])

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": r(v, h), "model.norm.weight": r(h, s=0.3)}
    for li in range(n_layers):
        p = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                  "post_feedforward_layernorm"):
            sd[p + n + ".weight"] = r(h, s=0.3)
        sd[p + "self_attn.q_norm.weight"] = r(hd, s=0.3)
        sd[p + "self_attn.k_norm.weight"] = r(hd, s=0.3)
        for n, shape in (("q", (nh * hd, h)), ("k", (nkv * hd, h)), ("v", (nkv * hd, h)),
                         ("o", (h, nh * hd))):
            sd[f"{p}self_attn.{n}_proj.weight"] = r(*shape)
        for n, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i))):
            sd[f"{p}mlp.{n}_proj.weight"] = r(*shape)
    return cfg, sd


def test_hf_dir_matches_jax_loader(tmp_path):
    cfg_d, sd = _hf_gemma3(np.random.default_rng(7))
    _write_hf(tmp_path, cfg_d, sd)
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert pipe.adapter is None and cfg.arch == jcfg.arch == "gemma3"
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _tree_equal(pipe.weights, carried)
    assert pipe.weights["lm_head"] is None and "k_norm" in pipe.weights["layers"][5]
    assert layer_windows(cfg).tolist() == jax_layer_windows(jcfg).tolist() == [4] * 5 + [0]
    # no tokenizer_config.json: the gemma fallback template
    text = pipe.chat_template.render([{"role": "user", "content": "hi"}])
    assert text == "<start_of_turn>user\nhi<end_of_turn>\n<start_of_turn>model\n"
    # a 10-token prompt in one chunk, then 2 decode steps: past the window of 4
    bs, n = 8, 10
    cache = PagedKVCache.create(cfg, 3, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, 3, bs, dtype=jnp.float32)
    bt = np.array([[0, 1, 2]], np.int32)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, n + 2)).astype(np.int32)
    for lo, hi in ((0, n), (n, n + 1), (n + 1, n + 2)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        kv = np.array([hi], np.int32)
        tl, cache = forward_paged(pipe.weights, cfg, torch.from_numpy(ids[:, lo:hi]).long(),
                                  torch.from_numpy(pos).long(), cache, torch.from_numpy(bt),
                                  torch.from_numpy(pos), torch.from_numpy(kv), block_size=bs,
                                  compute_dtype=torch.float32)
        jl, jc = jax_forward(jw, jcfg, jnp.asarray(ids[:, lo:hi]), jnp.asarray(pos), jc,
                             jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(kv), block_size=bs,
                             backend="xla", compute_dtype=jnp.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_directory_chat_template_comes_first(tmp_path):
    cfg_d, sd = _hf_gemma3(np.random.default_rng(8), n_layers=1)
    _write_hf(tmp_path, dict(cfg_d, layer_types=["full_attention"]), sd)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": "{{ bos_token }}[{{ messages[0]['content'] }}]", "bos_token": "<bos>"}))
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    assert pipe.chat_template.render([{"role": "user", "content": "x"}]) == "<bos>[x]"


def test_cli_serves_gemma3_dir_with_int8_kv(tmp_path):
    """``cli serve DIR --kv-quant int8`` on a tiny Gemma-3 directory with a
    WordLevel ``tokenizer.json``: the server answers a greedy chat
    request."""
    tokenizers = pytest.importorskip("tokenizers")
    cfg_d, sd = _hf_gemma3(np.random.default_rng(9))
    _write_hf(tmp_path, cfg_d, sd)
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel({f"w{i}": i for i in range(128)},
                                                           unk_token="w0"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mistralrs_tpu_torch.cli", "serve", str(tmp_path), "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64", "--kv-quant",
         "int8"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=Path(__file__).resolve().parent.parent)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving {tmp_path.name} on 127.0.0.1:"), line
        url = "http://" + line.split(" on ")[1].strip()
        body = {"model": tmp_path.name, "messages": [{"role": "user", "content": "w5 w6 w7"}],
                "max_tokens": 6, "temperature": 0.0}
        req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        assert 1 <= out["usage"]["completion_tokens"] <= 6
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_engine_greedy_matches_jax(monkeypatch, kv_quant):
    """A 20-token and a 13-token prompt in 8-token chunks, 10 greedy tokens
    each, through positions past the window of 8."""
    if kv_quant:
        xla_chunk_reading(monkeypatch)
    kw = dict(GEMMA3_KW, max_position_embeddings=64)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jw = _gemma3_weights(jcfg, 4, jnp.float32)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    engines_agree(jcfg, jw, cfg, tw, kv_quant, [rng.integers(0, 256, n).tolist()
                                                for n in (20, 13)])


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------


def test_conditional_generation_is_refused_by_name(tmp_path):
    """A ``Gemma3ForConditionalGeneration`` directory (its text model under
    ``text_config``, beside a vision tower) is refused by name."""
    d = {"architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
         "text_config": dict(PUBLISHED["12b"], model_type="gemma3_text"),
         "vision_config": {"model_type": "siglip_vision_model"}}
    (tmp_path / "config.json").write_text(json.dumps(d))
    write_safetensors(tmp_path / "model.safetensors", {"x": np.zeros(2, np.float32)})
    with pytest.raises(NotImplementedError, match="Gemma3ForConditionalGeneration"):
        load_pipeline(str(tmp_path), device="cpu")
