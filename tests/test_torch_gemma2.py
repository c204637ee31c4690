"""Gemma-2 in the port, on the CPU: sliding windows, the attention and final
logit softcaps, head_dim 256, the gemma norms and embedding multiplier, the
llama-family HF loader and the engine, each held against the JAX package.

* ``rms_norm_gemma`` against JAX's (bf16 bit-equal, f32 within 2e-6
  relative) and ``layer_windows`` (equal).
* The paged kernels' plain versions with these options against the JAX
  kernels: ``tests/test_torch_gemma2_attention.py``.
* ``forward_paged`` on a tiny 4-layer Gemma-2 (head_dim 256, window 8, both
  softcaps, post norms that are not ones) against JAX ``forward_paged``
  (``backend="xla"``) over a chunked prompt that crosses the window and 6
  decode steps: f32 rtol/atol 1e-4, bf16 atol 5e-2.
* HF directories (tiny Gemma-2, Gemma 1, Mistral with a uniform window,
  Llama with an untied and a tied head, Mixtral) written as safetensors: the port's
  ``load_pipeline`` gives the weights of JAX ``load_hf_model`` →
  ``from_jax_params`` exactly, and the same logits (atol 1e-4, f32).
* The engine's greedy tokens against the JAX engine's across the window,
  over bf16, int8 and fp8 pools.
* The options the 1-byte kernel forms once refused (sinks, windows,
  softcaps, head_dim 256) compute, against the f32 plain versions over the
  same values dequantized, and engines over int8 pools build with each.
* What stays refused raises ``NotImplementedError``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.gguf.writer import GGUFWriter
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.models.llama import layer_windows as jax_layer_windows
from mistralrs_tpu.ops.norms import rms_norm_gemma as jax_rms_norm_gemma
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import PagedKVCache, quantize_rows
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.models.llama import forward_paged, layer_windows
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.norms import rms_norm_gemma
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from mistralrs_tpu_torch.pipeline import load_pipeline

from test_torch_deepseek import write_safetensors
from test_torch_kv_quant_options import engines_agree, xla_chunk_reading
from test_torch_llama import jax_to_numpy

BS, N_KV = 16, 2  # the 1-byte option checks' small pools


# ---------------------------------------------------------------------------
# norms and windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gemma_matches_jax(dtype):
    """bf16: bit-equal (``1 + w`` taken in f32: in bf16 it would round, as
    1 + bf16(0.3) does). f32: within 2e-6 relative, as the port's plain
    ``rms_norm`` is: XLA's CPU rsqrt is not correctly rounded (from the
    same f32 variance it differs from ``torch.rsqrt`` by an ulp in about
    half the rows) and its mean sums in another order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.3
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)
    got = rms_norm_gemma(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), 1e-6)
    assert got.dtype == tdt
    want = np.asarray(jax_rms_norm_gemma(jx, jw, 1e-6).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("kw", [
    dict(arch="gemma2", sliding_window=4096),
    dict(arch="mistral", sliding_window=8),
    dict(arch="llama", sliding_window=16,
         layer_types=["sliding_attention", "full_attention"] * 3),
    dict(arch="gemma3", sliding_window=512),
    dict(arch="llama"),
])
def test_layer_windows_match_jax(kw):
    base = dict(vocab_size=8, hidden_size=8, intermediate_size=8, num_layers=6, num_heads=1,
                num_kv_heads=1, head_dim=8)
    got = layer_windows(ModelConfig(**base, **kw))
    np.testing.assert_array_equal(got, jax_layer_windows(JaxConfig(**base, **kw)))


# ---------------------------------------------------------------------------
# forward_paged, the HF loader and the engine
# ---------------------------------------------------------------------------

GEMMA_KW = dict(
    arch="gemma2", vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=256, sliding_window=8, attn_logit_softcap=50.0,
    logit_softcap=30.0, attn_scale=256 ** -0.5, rms_norm_eps=1e-6,
    hidden_act="gelu_pytorch_tanh", max_position_embeddings=256,
)


def _gemma_weights(jcfg, seed, jdt):
    """JAX random weights with post norms (not ones: they are stored as w - 1)
    and a final norm applied as 0.4 (stored -0.6), which keeps the logits
    at magnitude ~1, where the bf16 comparison's atol is stated."""
    jw = jax_init(jcfg, seed=seed, dtype=jdt, scale=0.1)
    rng = np.random.default_rng(seed + 100)
    shape = (jcfg.num_layers, jcfg.hidden_size)
    layers = dict(jw["layers"])
    for key in ("post_attn_norm", "post_ffn_norm"):
        layers[key] = jnp.asarray(rng.standard_normal(shape) * 0.2, jdt)
    final_norm = jnp.full((jcfg.hidden_size,), -0.6, jdt)
    return dict(jw, layers=layers, final_norm=final_norm)


def _gemma_steps():
    """Two rows (20- and 23-token prompts) in 8-token prefill chunks (each
    chunk after the first crosses the window of 8), then 6 decode steps."""
    rng = np.random.default_rng(5)
    prompt, n_dec, t, bs = (20, 23), 6, 8, 8
    bt = rng.permutation(2 * 4).astype(np.int32).reshape(2, 4)
    toks = [rng.integers(0, 256, p + n_dec).tolist() for p in prompt]

    def slot(b, p):
        return int(bt[b, p // bs] * bs + p % bs)

    steps = []
    for c in range(0, max(prompt), t):
        n = [max(0, min(t, p - c)) for p in prompt]
        ids = np.zeros((2, t), np.int32)
        pos = np.zeros((2, t), np.int32)
        slots = np.full((2, t), -1, np.int32)
        for b in range(2):
            ids[b, :n[b]] = toks[b][c:c + n[b]]
            pos[b, :n[b]] = np.arange(c, c + n[b])
            slots[b, :n[b]] = [slot(b, p) for p in range(c, c + n[b])]
        steps.append((ids, pos, slots, np.asarray([c + x for x in n], np.int32),
                      np.asarray(n, np.int32) - 1))
    for d in range(n_dec):
        p = np.asarray(prompt) + d
        steps.append((np.asarray([[toks[b][p[b]]] for b in range(2)], np.int32),
                      p[:, None].astype(np.int32),
                      np.asarray([[slot(b, p[b])] for b in range(2)], np.int32),
                      (p + 1).astype(np.int32), None))
    return bt, bs, steps


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gemma2_forward_paged_matches_jax(compute):
    """Logits of every step: f32 within rtol/atol 1e-4; bf16 within atol
    5e-2 and rows correlated > 0.999 (bf16 rounding of the activations,
    logits of magnitude ~1; JAX's bf16 run is as far from its f32 run)."""
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    jcfg, cfg = JaxConfig(**GEMMA_KW), ModelConfig(**GEMMA_KW)
    jw = _gemma_weights(jcfg, 3, jdt)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=tdt)
    assert layer_windows(cfg).tolist() == [8, 0, 8, 0] and "post_ffn_norm" in tw["layers"][3]
    bt, bs, steps = _gemma_steps()
    jc = JaxCache.create(jcfg, 9, bs, dtype=jdt)
    tc = PagedKVCache.create(cfg, 9, bs, dtype=tdt, device="cpu")
    reset_counts()
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
        jl = np.asarray(jl, np.float32)
        assert tl.shape == jl.shape and np.isfinite(tl.numpy()).all()
        assert np.abs(jl).max() <= 30.0  # the final softcap
        if compute == "float32":
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(tl.numpy(), jl, atol=5e-2)
            for a, b in zip(jl.reshape(-1, jl.shape[-1]), tl.numpy().reshape(-1, jl.shape[-1])):
                assert np.corrcoef(a, b)[0, 1] > 0.999
    assert COUNTS["paged_prefill_hd256_plain"] == 3 * 4 and COUNTS["paged_decode_hd256_plain"] == 6 * 4


def _hf_case(kind, rng):
    """(config.json dict, state dict of f32 numpy arrays) of a tiny model."""
    h, i, v, nl, nh, nkv, hd = 32, 64, 128, 2, 4, 2, 16
    cfg = {"vocab_size": v, "hidden_size": h, "intermediate_size": i, "num_hidden_layers": nl,
           "num_attention_heads": nh, "num_key_value_heads": nkv, "rms_norm_eps": 1e-6,
           "rope_theta": 10000.0, "max_position_embeddings": 128}
    if kind == "gemma2":
        hd = 64
        cfg.update(architectures=["Gemma2ForCausalLM"], model_type="gemma2", head_dim=hd,
                   hidden_act="gelu_pytorch_tanh", hidden_activation="gelu_pytorch_tanh",
                   sliding_window=4, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=64)
    elif kind == "gemma":  # gemma 1: gemma norms and multiplier, no post norms or softcaps
        cfg.update(architectures=["GemmaForCausalLM"], model_type="gemma", hidden_act="gelu")
    elif kind == "mistral":
        cfg.update(architectures=["MistralForCausalLM"], model_type="mistral", sliding_window=4)
    elif kind == "mixtral":
        cfg.update(architectures=["MixtralForCausalLM"], model_type="mixtral",
                   num_local_experts=4, num_experts_per_tok=2)
    else:
        cfg.update(architectures=["LlamaForCausalLM"], model_type="llama")
    cfg["head_dim"] = hd

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": r(v, h), "model.norm.weight": 1 + r(h)}
    if kind not in ("gemma2", "gemma", "llama_tied"):
        sd["lm_head.weight"] = r(v, h)
    norms = ["input_layernorm", "post_attention_layernorm"]
    if kind == "gemma2":
        norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    for li in range(nl):
        p = f"model.layers.{li}."
        for n in norms:
            sd[p + n + ".weight"] = r(h, s=0.3)
        for n, shape in (("q", (nh * hd, h)), ("k", (nkv * hd, h)), ("v", (nkv * hd, h)),
                         ("o", (h, nh * hd))):
            sd[f"{p}self_attn.{n}_proj.weight"] = r(*shape)
        if kind == "mixtral":
            sd[p + "block_sparse_moe.gate.weight"] = r(4, h, s=0.5)
            for e in range(4):
                for n, shape in (("w1", (i, h)), ("w3", (i, h)), ("w2", (h, i))):
                    sd[f"{p}block_sparse_moe.experts.{e}.{n}.weight"] = r(*shape)
        else:
            for n, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i))):
                sd[f"{p}mlp.{n}_proj.weight"] = r(*shape)
    return cfg, sd


def _write_hf(path, cfg, sd):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    write_safetensors(path / "model.safetensors", sd)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["gemma2", "gemma", "mistral", "llama", "llama_tied",
                                  "mixtral"])
def test_hf_dir_matches_jax_loader(tmp_path, kind):
    cfg_d, sd = _hf_case(kind, np.random.default_rng(len(kind)))
    _write_hf(tmp_path, cfg_d, sd)
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert pipe.adapter is None and cfg.arch == jcfg.arch
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _tree_equal(pipe.weights, carried)
    assert (pipe.weights["lm_head"] is None) == (kind in ("gemma2", "gemma", "llama_tied"))
    assert layer_windows(cfg).tolist() == jax_layer_windows(jcfg).tolist()
    # a prompt of 10 tokens in one chunk, then 2 decode steps: past the window of 4
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


def test_engine_greedy_matches_jax_across_the_window():
    """f32 engines: a 20-token and a 13-token prompt in 8-token chunks, 10
    greedy tokens each, through positions past the window of 8."""
    kw = dict(GEMMA_KW, max_position_embeddings=64)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jw = _gemma_weights(jcfg, 4, jnp.float32)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 13)]
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(cfg, tw, compute_dtype=torch.float32, device="cpu", **ekw)
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=10)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=10)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 10 for s in ts)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------


def _attend(kind, hd=128, seed=0, **opts):
    """One decode or prefill call on small random int8 pools with their
    scales, with ``opts``, and the same call on f32 pools of the same
    values dequantized, the step's rows as the quantized form reads them
    back (decode: code x bf16(s) from the pool; prefill: the chunk's
    bf16(code x s)) → (quantized output, f32 output, f32 output without
    ``opts``)."""
    rng = np.random.default_rng(seed)
    n_q, s_total = N_KV * 2, 4 * BS
    rows = [torch.from_numpy(rng.standard_normal((N_KV, s_total, hd)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2)]
    coded = [quantize_rows(r, torch.int8) for r in rows]
    codes = [c for c, _ in coded]
    scales = [sc.to(torch.bfloat16) for _, sc in coded]
    deq = [c.float() * sc.float()[..., None] for c, sc in zip(codes, scales)]
    t = 1 if kind == "decode" else 6
    new = [torch.from_numpy(rng.standard_normal((1, t, N_KV, hd)).astype(np.float32))
           .to(torch.bfloat16).float() for _ in range(2)]
    back = []
    for x in new:
        c, sc = quantize_rows(x, torch.int8)
        back.append(c.float() * sc.to(torch.bfloat16).float()[..., None] if kind == "decode"
                    else pa.chunk_round_trip(c, sc).float())
    q = torch.from_numpy(rng.standard_normal((1, t, n_q, hd)).astype(np.float32)) * 3
    bt = torch.arange(3, dtype=torch.int32)[None]
    kv_len = torch.tensor([40], dtype=torch.int32)
    slots = torch.arange(40 - t, 40, dtype=torch.int32)[None]

    def call(pools, rows, **kw):
        if kind == "decode":
            return paged_decode_attention_fused(q[:, 0], *pools, rows[0][:, 0], rows[1][:, 0],
                                                slots[:, 0], bt, kv_len, block_size=BS, **kw)
        return paged_prefill_attention_fused(q, *pools, *rows, slots, bt, kv_len,
                                             torch.tensor([t], dtype=torch.int32),
                                             block_size=BS, **kw)

    got = call([c.clone() for c in codes], new, k_scale=scales[0].clone(),
               v_scale=scales[1].clone(), **opts)
    return (got, call([d.clone() for d in deq], back, **opts),
            call([d.clone() for d in deq], back))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("case", ["sinks", "window", "softcap", "hd256"])
def test_refused_attention_options(kind, case):
    """Sinks, a window, a softcap or head_dim 256 on 1-byte pools, which the
    quantized forms once refused, compute: the int8 form's plain version
    (counted under its form's name) equals the f32 plain version over the
    same values dequantized within 1e-5, and each option but the head_dim
    moves the result by more than 1e-2."""
    hd = 256 if case == "hd256" else 128
    sinks = torch.from_numpy(np.linspace(-1, 3, N_KV * 2, dtype=np.float32))
    opts = {"sinks": dict(sinks=sinks), "window": dict(window=4),
            "softcap": dict(softcap=5.0), "hd256": {}}[case]
    reset_counts()
    got, want, without = _attend(kind, hd, seed=hd, **opts)
    name = f"paged_{kind}_int8" + ("_hd256" if hd == 256 else "")
    assert COUNTS[name + "_plain"] == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    if case != "hd256":
        assert (want - without).abs().max() > 1e-2


@pytest.mark.parametrize("case", ["window", "softcap", "hd256", "plain_llama"])
def test_engine_refuses_quantized_kv_options(monkeypatch, case):
    """An engine over int8 pools, which once refused a model with a sliding
    window, an attention softcap or head_dim 256, builds with each, as with
    a plain llama, and serves the JAX engine's greedy tokens (int8 pools,
    ``backend="xla"``, f32; the port reading a prefill chunk's own rows as
    the JAX XLA path does: ``test_torch_kv_quant_options.py``)."""
    xla_chunk_reading(monkeypatch)
    kw = dict(arch="llama", vocab_size=64, hidden_size=16, intermediate_size=32,
              num_layers=2, num_heads=2, num_kv_heads=1, head_dim=8,
              max_position_embeddings=64)
    kw.update({"window": dict(arch="mistral", sliding_window=4),
               "softcap": dict(attn_logit_softcap=5.0), "hd256": dict(head_dim=256),
               "plain_llama": {}}[case])
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jw = jax_init(jcfg, seed=1, dtype=jnp.float32, scale=0.3)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    engines_agree(jcfg, jw, cfg, tw, "int8", [rng.integers(0, 64, n).tolist() for n in (11, 6)],
                  max_tokens=6)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_engine_greedy_matches_jax_over_1byte_pools(monkeypatch, kv_quant):
    """The tiny Gemma-2 (window 8, both softcaps, head_dim 256) over int8
    and fp8 pools: the engines' greedy tokens across the window, as
    ``test_engine_greedy_matches_jax_across_the_window`` over bf16 pools
    (the port reading a prefill chunk's own rows as the JAX XLA path does:
    ``test_torch_kv_quant_options.py``)."""
    xla_chunk_reading(monkeypatch)
    kw = dict(GEMMA_KW, max_position_embeddings=64)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jw = _gemma_weights(jcfg, 4, jnp.float32)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    engines_agree(jcfg, jw, cfg, tw, kv_quant, [rng.integers(0, 256, n).tolist()
                                                for n in (20, 13)])


def test_gguf_gemma2_is_refused(tmp_path):
    """The JAX GGUF path reads no softcaps and adds gemma's 1 to norms that
    llama.cpp stored with it: the port loads Gemma-2 from HF only."""
    w = GGUFWriter(str(tmp_path / "g.gguf"))
    a = "gemma2"
    for key, val in (("block_count", 1), ("context_length", 64), ("embedding_length", 8),
                     ("feed_forward_length", 16), ("attention.head_count", 1),
                     ("attention.head_count_kv", 1)):
        w.add_metadata(f"{a}.{key}", np.uint32(val))
    w.add_metadata("general.architecture", a)
    w.add_tensor("token_embd.weight", np.zeros((4, 8), np.float32))
    w.write()
    with pytest.raises(NotImplementedError, match="gemma2"):
        load_gguf_model(str(tmp_path / "g.gguf"), device="cpu")


@pytest.mark.parametrize("case", ["quantization_config", "bias", "qk_norm", "phi3_fused"])
def test_hf_refusals(tmp_path, case):
    cfg_d, sd = _hf_case("llama", np.random.default_rng(0))
    if case == "quantization_config":  # GPTQ/AWQ and bnb 4-bit load since they were
        # ported; bnb 8-bit does not
        cfg_d["quantization_config"] = {"quant_method": "bitsandbytes", "load_in_8bit": True}
    elif case == "bias":  # attention biases load by name (Qwen2); MLP biases do not
        sd["model.layers.0.mlp.down_proj.bias"] = np.zeros(32, np.float32)
    elif case == "qk_norm":  # q/k norms load where the config has them (Qwen3, hunyuan)
        sd["model.layers.0.self_attn.q_norm.weight"] = np.ones(8, np.float32)
    else:  # phi3's fused projections load and split; as GPTQ words they do not
        cfg_d["quantization_config"] = {"quant_method": "gptq", "bits": 4}
        sd["model.layers.0.self_attn.qkv_proj.qweight"] = np.zeros((4, 128), np.int32)
    _write_hf(tmp_path, cfg_d, sd)
    with pytest.raises(NotImplementedError):
        load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
