"""The Qwen family in the port, on the CPU: Qwen2/Qwen2.5 (q/k/v biases with
no ``attention_bias`` key, GQA group 7), Qwen3 (per-head q/k norm before
RoPE, head_dim other than hidden / heads) and Qwen3-MoE (16 dense experts,
top-4, ``norm_topk_prob``, on the grouped route), each held against the
JAX package.

* ``config_from_hf`` on the published ``config.json`` of Qwen2.5-7B-Instruct,
  Qwen3-30B-A3B and Qwen3-8B: both packages' configs equal field for field
  and their ``layer_windows`` equal, Qwen2.5's also on the form
  ``transformers`` writes (``sliding_window`` null and ``layer_types``).
* Tiny HF directories whose tensor names and shapes come from
  ``transformers``' Qwen2/Qwen3/Qwen3Moe classes and whose values come from
  numpy: both loaders give equal weights (after ``from_jax_params``;
  ``fuse_projections`` then fuses q/k/v with their biases and each expert's
  gate and up), and
  ``forward_paged``'s f32 logits at every prefill chunk and decode step
  agree with JAX ``forward_paged`` (``backend="xla"``) within 1e-4. The
  Qwen3-MoE schedule's prefill chunks hold 80 tokens (JAX's every-expert
  scan) and its decode steps 2 (JAX's ``_sparse_expert_combine``).
* The engines' greedy tokens are identical (f32).
* The plain prefill at group 7 against the JAX prefill kernel in interpret
  mode (1e-2: that kernel rounds K, V and P to bf16) and JAX ``sdpa``
  (1e-4), one small case.
* ``cli serve`` answers a chat request on the tiny Qwen3-MoE directory.
* What stays refused: an engine whose GQA group is over 16.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import layer_windows as jax_layer_windows
from mistralrs_tpu.ops.attention import sdpa as jax_sdpa
from mistralrs_tpu.ops.paged_attention import paged_prefill_attention_fused as jax_prefill
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections, layer_windows
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import paged_prefill_attention_fused
from mistralrs_tpu_torch.pipeline import load_pipeline

from test_torch_deepseek import write_safetensors
from test_torch_gemma2 import _tree_equal
from test_torch_llama import jax_to_numpy

# huggingface.co/Qwen/Qwen2.5-7B-Instruct config.json
QWEN25_7B_JSON = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu", "hidden_size": 3584,
    "initializer_range": 0.02, "intermediate_size": 18944, "max_position_embeddings": 32768,
    "max_window_layers": 28, "model_type": "qwen2", "num_attention_heads": 28,
    "num_hidden_layers": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 131072, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "use_sliding_window": False,
    "vocab_size": 152064,
}
# huggingface.co/Qwen/Qwen3-30B-A3B config.json
QWEN3_30B_A3B_JSON = {
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 151643, "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 6144, "max_position_embeddings": 40960, "max_window_layers": 48,
    "mlp_only_layers": [], "model_type": "qwen3_moe", "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4,
    "output_router_logits": False, "rms_norm_eps": 1e-06, "rope_scaling": None,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936,
}
# huggingface.co/Qwen/Qwen3-8B config.json
QWEN3_8B_JSON = {
    "architectures": ["Qwen3ForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 12288,
    "max_position_embeddings": 40960, "max_window_layers": 36, "model_type": "qwen3",
    "num_attention_heads": 32, "num_hidden_layers": 36, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936,
}

# the tiny cases: transformers config class, its arguments
TINY = {
    # 7 query heads on 1 KV head (group 7), q/k/v biases, no attention_bias key
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(
        hidden_size=112, intermediate_size=96, num_attention_heads=7, num_key_value_heads=1)),
    # q/k norm, head_dim 32 != hidden 64 / 4 heads
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(
        hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32)),
    # 16 experts, top-4, renormalised; q/k norm
    "qwen3moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", dict(
        hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_experts=16, num_experts_per_tok=4, moe_intermediate_size=32,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[])),
}
COMMON = dict(vocab_size=128, num_hidden_layers=2, max_position_embeddings=128,
              tie_word_embeddings=False, rms_norm_eps=1e-6, rope_theta=1e6)


def test_config_matches_jax():
    """Each published config: both packages' ``ModelConfig`` equal field for
    field, and their ``layer_windows``. Qwen2.5 windows every layer at
    131072 (the JAX rule ignores ``use_sliding_window``; the window lies past
    ``max_position_embeddings``, so it never bites); the form ``transformers``
    4.57 writes (``sliding_window`` null, ``layer_types`` all full) windows
    none, in both packages alike."""
    tf_form = dict(QWEN25_7B_JSON, sliding_window=None, layer_types=["full_attention"] * 28)
    for d in (QWEN25_7B_JSON, tf_form, QWEN3_30B_A3B_JSON, QWEN3_8B_JSON):
        cfg, jcfg = config_from_hf(d), jax_config_from_hf(d)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        np.testing.assert_array_equal(layer_windows(cfg), jax_layer_windows(jcfg))
    q25 = config_from_hf(QWEN25_7B_JSON)
    assert (q25.arch, q25.num_heads // q25.num_kv_heads, q25.attention_bias) == ("qwen2", 7, False)
    assert set(layer_windows(q25).tolist()) == {131072}
    assert not layer_windows(config_from_hf(tf_form)).any()
    moe = config_from_hf(QWEN3_30B_A3B_JSON)
    assert (moe.arch, moe.qk_norm, moe.qk_norm_after_rope, moe.num_experts,
            moe.num_experts_per_tok, moe.moe_intermediate_size, moe.norm_topk_prob,
            moe.q_dim) == ("qwen3moe", True, False, 128, 8, 768, True, 4096)
    dense = config_from_hf(QWEN3_8B_JSON)
    assert (dense.arch, dense.qk_norm, dense.num_experts) == ("qwen3", True, 0)


@pytest.fixture(scope="module")
def layouts():
    """Each tiny case's HF ``config.json`` dict and its tensors' names and
    shapes, from ``transformers``' own classes (built once: importing
    ``transformers`` takes seconds)."""
    os.environ.setdefault("USE_TF", "0")  # transformers need not import TensorFlow
    transformers = pytest.importorskip("transformers")
    out = {}
    for kind, (cfg_cls, model_cls, kw) in TINY.items():
        hf_cfg = getattr(transformers, cfg_cls)(**COMMON, **kw)
        model = getattr(transformers, model_cls)(hf_cfg)
        d = hf_cfg.to_dict() | {"architectures": [model_cls]}
        if kind == "qwen2":  # the published form: a window key, no layer_types
            d = {k: v for k, v in d.items() if k != "layer_types"} | {"sliding_window": 4096}
        out[kind] = (d, {k: tuple(v.shape) for k, v in model.state_dict().items()})
    return out


def _write_dir(path, layout, seed):
    """The tiny checkpoint: every tensor of the layout drawn from numpy (norm
    weights 1 + N(0, 0.1^2), so q/k norm weights move the output; the rest
    N(0, 0.1^2); the router N(0, 0.5^2))."""
    cfg_d, shapes = layout
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32)
        if "norm" in name:
            a = 1 + 0.1 * a
        else:
            a *= 0.5 if name.endswith("mlp.gate.weight") else 0.1
        sd[name] = a
    (path / "config.json").write_text(json.dumps(cfg_d))
    write_safetensors(path / "model.safetensors", sd)
    return sd


def _steps(prompts, chunk, n_dec, bs, w, seed):
    """(block tables, [(ids, pos, slots, kv_lens, last_indices)]): rows of
    ``prompts`` tokens in ``chunk``-token prefill chunks, then ``n_dec``
    decode steps of every row."""
    rng = np.random.default_rng(seed)
    b = len(prompts)
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    toks = [rng.integers(0, 128, p + n_dec).tolist() for p in prompts]

    def slot(i, p):
        return int(bt[i, p // bs] * bs + p % bs)

    steps = []
    for c in range(0, max(prompts), chunk):
        n = [max(0, min(chunk, p - c)) for p in prompts]
        ids, pos = np.zeros((b, chunk), np.int32), np.zeros((b, chunk), np.int32)
        slots = np.full((b, chunk), -1, np.int32)
        for i in range(b):
            ids[i, :n[i]] = toks[i][c:c + n[i]]
            pos[i, :n[i]] = np.arange(c, c + n[i])
            slots[i, :n[i]] = [slot(i, p) for p in range(c, c + n[i])]
        steps.append((ids, pos, slots, np.asarray([c + x for x in n], np.int32),
                      np.asarray(n, np.int32) - 1))
    for d in range(n_dec):
        p = np.asarray(prompts) + d
        steps.append((np.asarray([[toks[i][p[i]]] for i in range(b)], np.int32), p[:, None],
                      np.asarray([[slot(i, p[i])] for i in range(b)], np.int32), p + 1, None))
    return bt, steps


# prompts, prefill chunk, decode steps (every chunk has a valid token in
# each row: a row with none has no defined output); qwen3moe's chunks of
# 2 x 40 tokens exceed JAX's 64-token sparse-combine limit, its decode steps
# do not
SCHEDULES = {"qwen2": ((21, 18), 8, 4), "qwen3": ((21, 18), 8, 4),
             "qwen3moe": ((45, 42), 40, 4)}


@pytest.mark.parametrize("kind", list(TINY))
def test_hf_dir_matches_jax(tmp_path, layouts, kind):
    """Both loaders on the tiny directory: the port's weights equal the JAX
    loader's carried across (exactly); f32 ``forward_paged`` logits at every
    prefill chunk and decode step within 1e-4 of JAX's (``backend="xla"``);
    the port's q/k/v fused with their biases, the experts on the grouped
    route."""
    _write_dir(tmp_path, layouts[kind], seed=len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert pipe.adapter is None and cfg.arch == jcfg.arch == kind
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _tree_equal(pipe.weights, carried)
    lw = pipe.weights["layers"][0]
    if kind == "qwen2":
        assert {"wq_bias", "wk_bias", "wv_bias"} <= set(lw) and "wo_bias" not in lw
    else:
        assert lw["q_norm"].shape == lw["k_norm"].shape == (cfg.head_dim,)
    weights = fuse_projections(pipe.weights, cfg)
    assert ("wqkv_bias" in weights["layers"][0]) == (kind == "qwen2")
    if kind == "qwen3moe":  # gate and up fused into one bank: one grouped launch
        assert weights["layers"][0]["experts"]["gateup"].shape == (16, 64, 64)
        assert weights["layers"][0]["experts"]["down"].shape == (16, 64, 32)
    prompts, chunk, n_dec = SCHEDULES[kind]
    bs, w = 8, 8
    bt, steps = _steps(prompts, chunk, n_dec, bs, w, seed=3)
    tc = PagedKVCache.create(cfg, len(prompts) * w, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, len(prompts) * w, bs, dtype=jnp.float32)
    reset_counts()
    for i, (ids, pos, slots, kv_lens, last) in enumerate(steps):
        decode = ids.shape[1] == 1
        jl, jc = jax_forward(jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
                             jnp.asarray(slots), jnp.asarray(kv_lens), block_size=bs,
                             backend="xla", compute_dtype=jnp.float32,
                             last_indices=None if decode else jnp.asarray(last))
        tl, tc = forward_paged(weights, cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(pos).long(), tc, torch.from_numpy(bt),
                               torch.from_numpy(slots), torch.from_numpy(kv_lens),
                               block_size=bs, compute_dtype=torch.float32,
                               last_indices=None if decode else torch.from_numpy(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{kind} step {i}")
    n_pre = len(steps) - n_dec
    assert COUNTS["paged_prefill_plain"] == 2 * n_pre
    assert COUNTS["paged_decode_plain"] == 2 * n_dec
    if kind == "qwen3moe":  # gate/up and down, both layers, every step
        assert COUNTS["dense_matmul_g_plain"] == 2 * 2 * len(steps)


@pytest.mark.parametrize("kind", list(TINY))
def test_engine_greedy_matches_jax(tmp_path, layouts, kind):
    """f32 engines on the tiny directory's weights: a 20-token and a
    13-token prompt in 8-token chunks, 6 greedy tokens each; the port's
    decode step (uncaptured on the CPU) runs the q/k norms and the routing."""
    _write_dir(tmp_path, layouts[kind], seed=10 + len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg), compute_dtype=torch.float32,
                device="cpu", **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, n).tolist() for n in (20, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=6)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=6)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 6 for s in ts)


def test_plain_prefill_group7_matches_jax_kernel():
    """The port's plain prefill at GQA group 7 (7 query heads on 1 KV head,
    head_dim 128), f32: 2 rows of a 12-token chunk, 12 valid on a past of
    9 and 5 valid on none; against the JAX prefill kernel in interpret mode
    (1e-2: it rounds K, V and P to bf16; V is N(0, 1/16)) and JAX ``sdpa``
    over the pools the plain version wrote (1e-4)."""
    rng = np.random.default_rng(7)
    b, t, n_kv, group, hd, bs, w = 2, 12, 1, 7, 128, 8, 4
    n_q = n_kv * group
    s_total = (b * w + 1) * bs
    kp = rng.standard_normal((n_kv, s_total, hd)).astype(np.float32)
    vp = rng.standard_normal((n_kv, s_total, hd)).astype(np.float32) * 0.25
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    n_valid = np.array([12, 5], np.int32)
    kv_lens = n_valid + np.array([9, 0], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((b, t), -1, np.int32)
    for i in range(b):
        slots[i, :n_valid[i]] = [int(bt[i, p // bs] * bs + p % bs)
                                 for p in range(ctx[i], kv_lens[i])]
    q = rng.standard_normal((b, t, n_q, hd)).astype(np.float32)
    kn = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32) * 0.25
    scale = 1 / math.sqrt(hd)
    k1, v1 = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    reset_counts()
    to = paged_prefill_attention_fused(
        torch.from_numpy(q), k1, v1, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(slots), torch.from_numpy(bt), torch.from_numpy(kv_lens),
        torch.from_numpy(n_valid), block_size=bs, scale=scale).numpy()
    assert COUNTS["paged_prefill_plain"] == 1 and sum(COUNTS.values()) == 1
    valid = np.arange(t)[None] < n_valid[:, None]
    jo, _, _ = jax_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                           jnp.asarray(vn), jnp.asarray(slots), jnp.asarray(bt),
                           jnp.asarray(kv_lens), jnp.asarray(n_valid), block_size=bs,
                           scale=scale, interpret=True)
    np.testing.assert_allclose(to[valid], np.asarray(jo)[valid], atol=1e-2)
    idx = bt.repeat(bs, axis=1) * bs + np.tile(np.arange(bs), w)[None]
    k_all, v_all = (np.stack([x.numpy()[:, row] for row in idx]).transpose(0, 2, 1, 3)
                    for x in (k1, v1))
    js = jax_sdpa(jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
                  q_positions=jnp.asarray(ctx[:, None] + np.arange(t)[None]),
                  kv_len=jnp.asarray(kv_lens), scale=scale)
    np.testing.assert_allclose(to[valid], np.asarray(js)[valid], atol=1e-4)


def test_cli_serves_qwen3moe_dir(tmp_path, layouts):
    """``cli serve DIR`` on the tiny Qwen3-MoE directory with a WordLevel
    ``tokenizer.json``: the server answers a greedy chat request."""
    tokenizers = pytest.importorskip("tokenizers")
    _write_dir(tmp_path, layouts["qwen3moe"], seed=5)
    cfg_d = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg_d, eos_token_id=1)))
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel({f"w{i}": i for i in range(128)},
                                                           unk_token="w0"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mistralrs_tpu_torch.cli", "serve", str(tmp_path), "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64"],
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


def test_engine_refuses_gqa_group_over_16():
    """The decode kernel takes GQA groups 1 to 16: an engine over a model
    with 17 query heads on one KV head is refused before its pools."""
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=17 * 8, intermediate_size=32,
                      num_layers=1, num_heads=17, num_kv_heads=1, head_dim=8)
    with pytest.raises(NotImplementedError, match="GQA group 17/1"):
        Engine(cfg, {"layers": []}, num_blocks=4, block_size=8, max_batch=1, device="cpu")
