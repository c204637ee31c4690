"""gpt-oss in the port, on the CPU: attention sinks and head_dim 64 in the
paged kernels' plain versions, YaRN, q/k/v/o biases, the router bias, the
clamped-SwiGLU experts on the grouped route, MXFP4 expert banks, the HF
loader and the engine, each held against the JAX package.

* ``config_from_hf`` on gpt-oss-20b's ``config.json``: both packages' configs
  equal.
* ``rope_frequencies`` with YaRN (``truncate`` true and false) and
  ``yarn_attention_factor``: within 1e-6.
* MXFP4 decoding: bit-exact against JAX ``dequantize_mxfp4``.
* The plain paged decode and prefill with sinks at head_dim 64 and 128,
  GQA groups 1, 4 and 8, with a window, a softcap, a kv_len of 0 and rows
  with n_valid < T: against JAX ``sdpa`` with sinks and against the JAX
  kernels in interpret mode, which the JAX package reaches at head_dim 64
  with its rows padded to 128 (f32, atol 1e-4).
* The expert MLP (router, router bias, top-k then softmax, the grouped
  route's two dense grouped products with their per-row biases and the
  clamp) against JAX ``_moe_mlp`` → ``_gpt_oss_experts`` at both row tiles
  (16 and 64 rows).
* ``forward_paged`` on a tiny 4-layer gpt-oss (sliding and full layers,
  window 8, YaRN, head_dim 16 and 64) against JAX ``forward_paged``
  (``backend="xla"``) over a chunked prompt that crosses the window and 6
  decode steps: f32 rtol/atol 1e-4; bf16 atol 5e-2 with rows correlated
  > 0.999.
* HF directories of a tiny gpt-oss, bf16-style dense banks and MXFP4 banks
  (blocks from JAX ``quantize_mxfp4``): both loaders give the same weights
  (after ``from_jax_params``) and the same logits.
* ``cli serve`` answers a chat request on the MXFP4 directory.
* The engine's greedy tokens equal the JAX engine's across the window,
  over bf16, int8 and fp8 pools, and the uncaptured decode step's logits
  equal JAX ``forward_paged``'s.
* What stays refused: random gpt-oss weights, another
  ``quantization_config``.
"""

import dataclasses
import json
import math
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
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import _moe_mlp as jax_moe_mlp
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.ops.attention import sdpa as jax_sdpa
from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from mistralrs_tpu.ops.rope import yarn_attention_factor as jax_yarn_factor
from mistralrs_tpu.quant.mxfp4 import dequantize_mxfp4 as jax_dequantize_mxfp4
from mistralrs_tpu.quant.mxfp4 import quantize_mxfp4
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import (
    _moe_mlp,
    forward_paged,
    fuse_projections,
    init_random_weights,
)
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from mistralrs_tpu_torch.ops.rope import rope_frequencies, yarn_attention_factor
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant.mxfp4 import dequantize_mxfp4

from test_torch_deepseek import write_safetensors
from test_torch_gemma2 import _gemma_steps, _tree_equal
from test_torch_kv_quant_options import engines_agree, xla_chunk_reading
from test_torch_llama import jax_to_numpy

# gpt-oss-20b's config.json (huggingface.co/openai/gpt-oss-20b)
GPT_OSS_20B_JSON = {
    "architectures": ["GptOssForCausalLM"], "attention_bias": True, "attention_dropout": 0.0,
    "eos_token_id": 200002, "experts_per_token": 4, "head_dim": 64, "hidden_act": "silu",
    "hidden_size": 2880, "initial_context_length": 4096, "initializer_range": 0.02,
    "intermediate_size": 2880,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "max_position_embeddings": 131072, "model_type": "gpt_oss", "num_attention_heads": 64,
    "num_experts_per_tok": 4, "num_hidden_layers": 24, "num_key_value_heads": 8,
    "num_local_experts": 32, "output_router_logits": False, "pad_token_id": 199999,
    "quantization_config": {
        "modules_to_not_convert": ["model.layers.*.self_attn", "model.layers.*.mlp.router",
                                   "model.embed_tokens", "lm_head"],
        "quant_method": "mxfp4"},
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0,
                     "original_max_position_embeddings": 4096, "rope_type": "yarn",
                     "truncate": False},
    "rope_theta": 150000, "router_aux_loss_coef": 0.9, "sliding_window": 128,
    "swiglu_limit": 7.0, "tie_word_embeddings": False, "use_cache": True,
    "vocab_size": 201088,
}

YARN = {"rope_type": "yarn", "factor": 8.0, "beta_fast": 32.0, "beta_slow": 1.0,
        "truncate": False, "original_max_position_embeddings": 64}


def _kw(hd: int) -> dict:
    """A tiny gpt-oss: 4 layers alternating sliding (window 8) and full,
    8 experts top-2, YaRN as ``tests/test_arch_parity.py::test_gpt_oss``;
    head_dim 16 at GQA group 2, or 64 at group 8 (gpt-oss-20b's)."""
    heads = dict(num_heads=4, num_kv_heads=2) if hd == 16 else dict(num_heads=8, num_kv_heads=1)
    return dict(arch="gpt_oss", vocab_size=256, hidden_size=64, intermediate_size=32,
                num_layers=4, head_dim=hd, **heads, num_experts=8, num_experts_per_tok=2,
                sliding_window=8, layer_types=["sliding_attention", "full_attention"] * 2,
                rope_theta=150000.0, rope_scaling=YARN, attention_bias=True,
                max_position_embeddings=128, rms_norm_eps=1e-5)


def _jax_weights(kw: dict, seed: int, jdt, scale: float = 0.1, router: float = 0.5):
    """The JAX package's gpt-oss weights: ``init_random_weights`` for the
    embedding, norms, projections and head, then the q/k/v/o biases, the
    sinks (N(0, 1): they move the softmax), the router and its bias, and the
    expert banks in the JAX layout (``gate_up`` [L, E, H, 2I] with gate and
    up interleaved, ``down`` [L, E, I, H]) with their biases."""
    jcfg = JaxConfig(**kw)
    jw = jax_init(jcfg, seed=seed, dtype=jdt, scale=scale)
    rng = np.random.default_rng(seed + 1)
    nl, h, e, i = kw["num_layers"], kw["hidden_size"], kw["num_experts"], kw["intermediate_size"]
    q_dim, kv_dim = kw["num_heads"] * kw["head_dim"], kw["num_kv_heads"] * kw["head_dim"]

    def r(*shape, s=scale):
        return jnp.asarray(rng.standard_normal(shape) * s, jdt)

    layers = {k: v for k, v in jw["layers"].items() if k not in ("gate", "up", "down")}
    layers.update(wq_bias=r(nl, q_dim), wk_bias=r(nl, kv_dim), wv_bias=r(nl, kv_dim),
                  wo_bias=r(nl, h), sinks=r(nl, kw["num_heads"], s=1.0),
                  router=r(nl, e, h, s=router), router_bias=r(nl, e, s=0.5),
                  experts={"gate_up": r(nl, e, h, 2 * i), "gate_up_bias": r(nl, e, 2 * i),
                           "down": r(nl, e, i, h), "down_bias": r(nl, e, h)})
    return jcfg, {**jw, "layers": layers, "final_norm": jnp.full((h,), 0.4, jdt)}


# ---------------------------------------------------------------------------
# config, YaRN, MXFP4
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    jcfg, cfg = jax_config_from_hf(GPT_OSS_20B_JSON), config_from_hf(GPT_OSS_20B_JSON)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.arch, cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.num_experts, cfg.num_experts_per_tok, cfg.sliding_window,
            cfg.attention_bias) == ("gpt_oss", 24, 2880, 64, 8, 64, 32, 4, 128, True)


@pytest.mark.parametrize("truncate", [True, False])
@pytest.mark.parametrize("hd,theta,factor,orig", [(64, 150000.0, 32.0, 4096),
                                                  (16, 150000.0, 8.0, 64),
                                                  (128, 10000.0, 4.0, 2048)])
def test_yarn_matches_jax(hd, theta, factor, orig, truncate):
    scaling = dict(YARN, factor=factor, original_max_position_embeddings=orig,
                   truncate=truncate)
    got = rope_frequencies(hd, theta, scaling).numpy()
    want = np.asarray(jax_rope_frequencies(hd, theta, scaling))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not np.allclose(got, rope_frequencies(hd, theta, None).numpy())  # YaRN bites
    assert yarn_attention_factor(scaling) == pytest.approx(jax_yarn_factor(scaling), abs=1e-6)
    assert yarn_attention_factor(None) == 1.0 == jax_yarn_factor(None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mxfp4_decode_is_bit_exact(dtype):
    """Every code in both nibbles, scales from the subnormal 2^-127 (0) to
    2^127 (254): the values of JAX's f32 decode, exactly."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, (3, 5, 7, 16), dtype=np.uint8)
    blocks[0, 0, 0] = np.arange(16, dtype=np.uint8) * 17  # code c in both nibbles
    scales = rng.integers(100, 155, (3, 5, 7), dtype=np.uint8)
    scales[0, 0, :3] = (0, 1, 254)
    want = jax_dequantize_mxfp4(blocks, scales)
    got = dequantize_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales), dtype)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the paged kernels' plain versions with sinks, head_dim 64 and 128
# ---------------------------------------------------------------------------

BS, W, N_KV = 16, 4, 2


def _slot(bt, b, p):
    return int(bt[b, p // BS] * BS + p % BS)


def _pools(rng, b, hd):
    s_total = (b * W + 1) * BS
    kp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    vp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    return kp, vp, bt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seq(pool, bt):
    """A pool [n_kv, S, hd] gathered through the tables bt [B, W] → [B, W *
    BS, n_kv, hd], sdpa's layout."""
    idx = bt.repeat(BS, axis=1) * BS + np.tile(np.arange(BS), W)[None]
    return np.stack([pool[:, row] for row in idx]).transpose(0, 2, 1, 3)


def _lanes(a):
    """``a`` zero-padded to 128 head dims, as the JAX package reaches its
    kernels at head_dim 64 (``kv/paged.py::auto_head_dim_pad``,
    ``models/llama.py:1098-1102``): zeros add nothing to the products."""
    pad = 128 - a.shape[-1]
    return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]) if pad > 0 else a)


# (window, softcap): full attention; a window of 5 with the softcap, which
# does not reach the sinks
OPTIONS = ((0, 0.0), (5, 30.0))


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_plain_decode_with_sinks_matches_jax(hd, group):
    """f32, scale 1/sqrt(hd), sinks N(0, 2^2); rows: kv_len 0 (zeros), one
    position, a dropped write, a whole table. Against the JAX kernel in
    interpret mode and JAX ``sdpa`` with sinks (atol 1e-4); the sinks move
    the output by more than 0.05."""
    rng = np.random.default_rng(hd + group)
    b, n_q = 4, N_KV * group
    kp, vp, bt = _pools(rng, b, hd)
    kv_lens = np.array([0, 1, 37, W * BS], np.int32)
    q = rng.standard_normal((b, n_q, hd)).astype(np.float32)
    kn = rng.standard_normal((b, N_KV, hd)).astype(np.float32)
    vn = rng.standard_normal((b, N_KV, hd)).astype(np.float32)
    slots = np.array([-1, _slot(bt, 1, 0), -1, _slot(bt, 3, W * BS - 1)], np.int32)
    sinks = (rng.standard_normal(n_q) * 2).astype(np.float32)
    scale = 1 / math.sqrt(hd)
    for window, softcap in OPTIONS:
        outs = {}
        for s in (sinks, None):
            reset_counts()
            k1, v1 = _t(kp.copy()), _t(vp.copy())
            outs[s is None] = paged_decode_attention_fused(
                _t(q), k1, v1, _t(kn), _t(vn), _t(slots), _t(bt), _t(kv_lens), block_size=BS,
                scale=scale, window=window, softcap=softcap,
                sinks=None if s is None else _t(s))
            name = "paged_decode_hd64" if hd == 64 else "paged_decode"
            assert COUNTS[name + "_plain"] == 1 and sum(COUNTS.values()) == 1
        to = outs[False]
        assert (to[0] == 0).all()  # kv_len 0: zeros, sinks or not
        assert (to - outs[True]).abs().max() > 0.05
        jo, _, _ = jax_decode(_lanes(q), _lanes(kp), _lanes(vp), _lanes(kn), _lanes(vn),
                              jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens), window,
                              0, None, jnp.asarray(sinks), block_size=BS, scale=scale,
                              softcap=softcap, interpret=True)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo)[..., :hd], atol=1e-4,
                                   err_msg=f"window {window}")
        # sdpa over the pools as the plain version wrote them
        k_all, v_all = (_seq(x.numpy(), bt) for x in (k1, v1))
        js = jax_sdpa(jnp.asarray(q[:, None]), jnp.asarray(k_all), jnp.asarray(v_all),
                      q_positions=jnp.asarray(kv_lens - 1)[:, None], kv_len=jnp.asarray(kv_lens),
                      scale=scale, logit_softcap=softcap or None,
                      sliding_window=window or None, sinks=jnp.asarray(sinks))
        np.testing.assert_allclose(to.numpy()[1:], np.asarray(js)[1:, 0], atol=1e-4)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_plain_prefill_with_sinks_matches_jax(hd, group):
    """f32, 3 rows of a 12-token chunk: 12 valid on a past of 9 (the
    chunk crosses the window's edge), 5 valid on none, 0 valid (its output
    is never read). Against JAX ``sdpa`` with sinks (atol 1e-4) and the JAX
    kernel in interpret mode (atol 1e-2: that kernel rounds K, V and P to
    bf16 for its products; V is N(0, 1/16), so outputs stay below 1)."""
    rng = np.random.default_rng(10 * hd + group)
    b, t, n_q = 3, 12, N_KV * group
    kp, vp, bt = _pools(rng, b, hd)
    n_valid = np.array([12, 5, 0], np.int32)
    kv_lens = n_valid + np.array([9, 0, 20], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((b, t), -1, np.int32)
    for i in range(b):
        slots[i, :n_valid[i]] = [_slot(bt, i, ctx[i] + j) for j in range(n_valid[i])]
    q = rng.standard_normal((b, t, n_q, hd)).astype(np.float32)
    kn = rng.standard_normal((b, t, N_KV, hd)).astype(np.float32)
    vn = rng.standard_normal((b, t, N_KV, hd)).astype(np.float32) * 0.25
    vp *= 0.25
    sinks = (rng.standard_normal(n_q) * 2).astype(np.float32)
    scale = 1 / math.sqrt(hd)
    valid = np.arange(t)[None] < n_valid[:, None]
    for window, softcap in OPTIONS:
        outs = {}
        for s in (sinks, None):
            reset_counts()
            k1, v1 = _t(kp.copy()), _t(vp.copy())
            outs[s is None] = paged_prefill_attention_fused(
                _t(q), k1, v1, _t(kn), _t(vn), _t(slots), _t(bt),
                _t(kv_lens), _t(n_valid), block_size=BS, scale=scale, window=window,
                softcap=softcap, sinks=None if s is None else _t(s))
            name = "paged_prefill_hd64" if hd == 64 else "paged_prefill"
            assert COUNTS[name + "_plain"] == 1 and sum(COUNTS.values()) == 1
        to = outs[False].numpy()
        assert np.abs(to - outs[True].numpy())[valid].max() > 0.02
        jo, _, _ = jax_prefill(_lanes(q), _lanes(kp), _lanes(vp), _lanes(kn), _lanes(vn),
                               jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens),
                               jnp.asarray(n_valid), window, 0, None, jnp.asarray(sinks),
                               block_size=BS, scale=scale, softcap=softcap, interpret=True)
        np.testing.assert_allclose(to[valid], np.asarray(jo)[..., :hd][valid], atol=1e-2,
                                   err_msg=f"window {window}")
        # sdpa over the pools as the plain version wrote them
        k_all, v_all = (_seq(x.numpy(), bt) for x in (k1, v1))
        js = jax_sdpa(jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
                      q_positions=jnp.asarray(ctx[:, None] + np.arange(t)[None]),
                      kv_len=jnp.asarray(kv_lens), scale=scale, logit_softcap=softcap or None,
                      sliding_window=window or None, sinks=jnp.asarray(sinks))
        np.testing.assert_allclose(to[valid], np.asarray(js)[valid], atol=1e-4)


# ---------------------------------------------------------------------------
# the expert MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("tokens", [6, 200])
def test_expert_mlp_matches_jax(tokens, plain):
    """The router with its bias, top-2 then softmax, the grouped route (16-row
    tiles at 6 tokens, 64-row tiles at 200) against JAX ``_moe_mlp``, f32:
    inputs of std 3, so that the clamp at 7 bites on gate and up."""
    kw = _kw(16)
    jcfg, jw = _jax_weights(kw, 7, jnp.float32, scale=0.3)
    cfg = ModelConfig(**kw)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    x = (np.random.default_rng(8).standard_normal((2, tokens // 2, kw["hidden_size"])) * 3
         ).astype(np.float32)
    jlw = {k: (v[1] if k != "experts" else {kk: vv[1] for kk, vv in v.items()})
           for k, v in jw["layers"].items()}
    want = np.asarray(jax_moe_mlp(jnp.asarray(x), jlw, jcfg, None, None))
    ex = tw["layers"][1]["experts"]
    gu = (torch.from_numpy(x).reshape(-1, kw["hidden_size"]) @ ex["gateup"].transpose(1, 2)
          + ex["gateup_bias"][:, None])
    assert (gu[..., :32] > 7).any() and (gu[..., 32:].abs() > 7).any()  # the clamp bites
    reset_counts()
    got = _moe_mlp(torch.from_numpy(x), tw["layers"][1], cfg, plain=plain)
    assert COUNTS["dense_matmul_g_plain"] == 2 and sum(COUNTS.values()) == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _run_forward(jw, jcfg, tw, cfg, jdt, tdt):
    """Both packages' logits at every step of ``_gemma_steps`` (two prompts
    of 20 and 23 tokens in 8-token chunks past the window of 8, then 6
    decode steps)."""
    bt, bs, steps = _gemma_steps()
    jc = JaxCache.create(jcfg, 9, bs, dtype=jdt)
    tc = PagedKVCache.create(cfg, 9, bs, dtype=tdt, device="cpu")
    out = []
    for ids, pos, slots, kv_lens, last in steps:
        jl, jc = jax_forward(jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
                             jnp.asarray(slots), jnp.asarray(kv_lens), block_size=bs,
                             backend="xla", compute_dtype=jdt,
                             last_indices=None if last is None else jnp.asarray(last))
        tl, tc = forward_paged(tw, cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(pos).long(), tc, torch.from_numpy(bt),
                               torch.from_numpy(slots), torch.from_numpy(kv_lens),
                               block_size=bs, compute_dtype=tdt,
                               last_indices=None if last is None else torch.from_numpy(last))
        out.append((tl.float().numpy(), np.asarray(jl, np.float32)))
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_forward_paged_matches_jax(hd, compute):
    """Logits of every step: f32 within rtol/atol 1e-4; bf16 within atol
    5e-2 and rows correlated > 0.999, logits of magnitude ~1 (a final norm
    of 0.4). In bf16 every token takes all 8 experts (top-8, weighted by the
    softmax of the biased logits): at top-2, near-tied router logits pick
    other experts under either package's bf16 rounding (JAX's own bf16 run
    is 0.5 from its f32 run at one step of this schedule, the port's 0.025),
    which the f32 case covers. The port's q/k/v are fused with their biases
    (``fuse_projections``); both attention kernels run their plain versions
    with sinks (their head_dim-64 forms at 64)."""
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    kw = _kw(hd) if compute == "float32" else dict(_kw(hd), num_experts_per_tok=8)
    jcfg, jw = _jax_weights(kw, 3, jdt)
    cfg = ModelConfig(**kw)
    tw = fuse_projections(from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=tdt), cfg)
    assert "wqkv_bias" in tw["layers"][0] and tw["layers"][0]["sinks"].dtype == torch.float32
    reset_counts()
    for tl, jl in _run_forward(jw, jcfg, tw, cfg, jdt, tdt):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        if compute == "float32":
            np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(tl, jl, atol=5e-2)
            for a, b in zip(jl.reshape(-1, jl.shape[-1]), tl.reshape(-1, jl.shape[-1])):
                assert np.corrcoef(a, b)[0, 1] > 0.999
    suffix = "_hd64" if hd == 64 else ""
    assert COUNTS[f"paged_prefill{suffix}_plain"] == 3 * 4
    assert COUNTS[f"paged_decode{suffix}_plain"] == 6 * 4


def _hf_case(rng, mxfp4: bool):
    """(config.json dict, state dict) of a tiny gpt-oss checkpoint: dense f32
    expert banks in the HF layout, or MXFP4 blocks and scales of the
    transposed banks (their decoded values are the model's)."""
    h, i, v, nl, nh, nkv, hd, e = 64, 32, 128, 2, 4, 2, 16, 4
    cfg = {"architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss", "vocab_size": v,
           "hidden_size": h, "intermediate_size": i, "num_hidden_layers": nl,
           "num_attention_heads": nh, "num_key_value_heads": nkv, "head_dim": hd,
           "num_local_experts": e, "num_experts_per_tok": 2, "experts_per_token": 2,
           "sliding_window": 4, "layer_types": ["sliding_attention", "full_attention"],
           "attention_bias": True, "rope_theta": 150000.0, "rope_scaling": YARN,
           "rms_norm_eps": 1e-5, "max_position_embeddings": 128, "tie_word_embeddings": False,
           "swiglu_limit": 7.0}
    if mxfp4:
        cfg["quantization_config"] = {"quant_method": "mxfp4"}

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": r(v, h), "model.norm.weight": 1 + r(h),
          "lm_head.weight": r(v, h)}
    for li in range(nl):
        p = f"model.layers.{li}."
        sd[p + "input_layernorm.weight"] = 1 + r(h)
        sd[p + "post_attention_layernorm.weight"] = 1 + r(h)
        for n, out in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd)):
            sd[f"{p}self_attn.{n}_proj.weight"] = r(out, h)
            sd[f"{p}self_attn.{n}_proj.bias"] = r(out)
        sd[p + "self_attn.o_proj.weight"] = r(h, nh * hd)
        sd[p + "self_attn.o_proj.bias"] = r(h)
        sd[p + "self_attn.sinks"] = r(nh, s=1.0)
        sd[p + "mlp.router.weight"] = r(e, h, s=0.5)
        sd[p + "mlp.router.bias"] = r(e, s=0.5)
        banks = {"gate_up_proj": r(e, h, 2 * i, s=0.3), "down_proj": r(e, i, h, s=0.3)}
        for name, w in banks.items():
            stem = f"{p}mlp.experts.{name}"
            if mxfp4:
                blocks, scales = quantize_mxfp4(np.swapaxes(w, 1, 2))  # [E, out, in]
                sd[stem + "_blocks"], sd[stem + "_scales"] = blocks, scales
            else:
                sd[stem] = w
            sd[stem + "_bias"] = r(e, w.shape[-1])
    return cfg, sd


@pytest.mark.parametrize("mxfp4", [False, True])
def test_hf_dir_matches_jax_loader(tmp_path, mxfp4):
    cfg_d, sd = _hf_case(np.random.default_rng(11), mxfp4)
    (tmp_path / "config.json").write_text(json.dumps(cfg_d))
    write_safetensors(tmp_path / "model.safetensors", sd)
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert pipe.adapter is None and cfg.arch == jcfg.arch == "gpt_oss"
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _tree_equal(pipe.weights, carried)
    ex = pipe.weights["layers"][0]["experts"]
    assert ex["gateup"].shape == (4, 64, 64) and ex["down"].shape == (4, 64, 32)
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


def test_cli_serves_gpt_oss_mxfp4_dir(tmp_path):
    """``cli serve DIR`` on the tiny MXFP4 gpt-oss directory with a
    WordLevel ``tokenizer.json``: the server answers a greedy chat request."""
    tokenizers = pytest.importorskip("tokenizers")
    cfg_d, sd = _hf_case(np.random.default_rng(12), mxfp4=True)
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg_d, eos_token_id=1)))
    write_safetensors(tmp_path / "model.safetensors", sd)
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


def _engines(hd=16):
    kw = _kw(hd)
    jcfg, jw = _jax_weights(kw, 4, jnp.float32)
    cfg = ModelConfig(**kw)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    return (JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw),
            Engine(cfg, tw, compute_dtype=torch.float32, device="cpu", **ekw), jw, jcfg)


def test_engine_greedy_matches_jax_across_the_window():
    """f32 engines: a 20-token and a 13-token prompt in 8-token chunks, 10
    greedy tokens each, through positions past the window of 8."""
    je, te, _, _ = _engines()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=10)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=10)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 10 for s in ts)


def test_uncaptured_decode_step_matches_jax_forward():
    """The engine's decode step (uncaptured on the CPU) after a 13-token
    prefill, 3 steps (to the end of its second block): its logits equal JAX
    ``forward_paged``'s on a JAX cache prefilled through the same block
    table (atol 1e-4, f32)."""
    _, te, jw, jcfg = _engines(hd=64)
    prompt = np.random.default_rng(6).integers(0, 256, 13).tolist()
    seq = te.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=8))
    while not seq.generated_ids:
        te.step()
    table = te.kv.block_table(seq.request_id)
    bs = te.block_size
    jc = JaxCache.create(jcfg, 16, bs, dtype=jnp.float32)
    bt = np.zeros((1, 4), np.int32)
    bt[0, :len(table)] = table
    pos = np.arange(13, dtype=np.int32)[None]
    slots = np.asarray([[table[p // bs] * bs + p % bs for p in range(13)]], np.int32)
    _, jc = jax_forward(jw, jcfg, jnp.asarray([prompt]), jnp.asarray(pos), jc, jnp.asarray(bt),
                        jnp.asarray(slots), jnp.asarray([13]), block_size=bs, backend="xla",
                        compute_dtype=jnp.float32)
    ds, width = te.decode_step, te._max_blocks_bucket()
    tok = seq.all_ids[-1]
    for i in range(3):
        p = 13 + i
        table = te.kv.block_table(seq.request_id)
        assert p < bs * len(table)
        a = ds.staging(width)
        a[seq.slot, :4] = (tok, p, table[p // bs] * bs + p % bs, p + 1)
        a[seq.slot, 4:4 + len(table)] = table
        ds.upload(width)
        out = ds.compute(width)
        bt[0, :len(table)] = table
        jl, jc = jax_forward(jw, jcfg, jnp.asarray([[tok]]), jnp.asarray([[p]]), jc,
                             jnp.asarray(bt), jnp.asarray([[a[seq.slot, 2]]]),
                             jnp.asarray([p + 1]), block_size=bs, backend="xla",
                             compute_dtype=jnp.float32)
        np.testing.assert_allclose(out.logits[seq.slot].numpy(), np.asarray(jl)[0, 0],
                                   atol=1e-4, err_msg=f"step {i}")
        tok = int(out.tokens[seq.slot])


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_engine_refuses_quantized_kv_for_gpt_oss(monkeypatch, kv_quant):
    """An engine over gpt-oss (sinks, windows of 8, head_dim 64) with 1-byte
    pools, which was once refused as it was built, builds and serves the JAX
    engine's greedy tokens (the same ``kv_quant``, ``backend="xla"``, f32;
    the port reading a prefill chunk's own rows as the JAX XLA path does:
    ``test_torch_kv_quant_options.py``): a 20- and a 13-token prompt in
    8-token chunks, 10 tokens each."""
    xla_chunk_reading(monkeypatch)
    kw = _kw(64)
    jcfg, jw = _jax_weights(kw, 4, jnp.float32)
    cfg = ModelConfig(**kw)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    engines_agree(jcfg, jw, cfg, tw, kv_quant, [rng.integers(0, 256, n).tolist()
                                                for n in (20, 13)])


@pytest.mark.parametrize("case", ["random_weights", "gptq_config", "mlp_bias"])
def test_gpt_oss_refusals(tmp_path, case):
    if case == "random_weights":
        with pytest.raises(NotImplementedError, match="gpt-oss"):
            init_random_weights(ModelConfig(**_kw(16)), device="cpu")
        return
    cfg_d, sd = _hf_case(np.random.default_rng(0), mxfp4=False)
    if case == "gptq_config":
        cfg_d["quantization_config"] = {"quant_method": "gptq", "bits": 4}
    else:
        cfg_d["mlp_bias"] = True
    (tmp_path / "config.json").write_text(json.dumps(cfg_d))
    write_safetensors(tmp_path / "model.safetensors", sd)
    with pytest.raises(NotImplementedError):
        load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
