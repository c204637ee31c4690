"""The port's DeepSeek path (``mistralrs_tpu_torch.models.deepseek``, the MLA
decode op, the engine's ``DeepseekAdapter``, the safetensors loader and
``load_pipeline`` on a HF directory) against the JAX package on the CPU.

Tiny configs (hidden 64, rank 128 as the JAX kernel needs ``rank % 128 ==
0``, rope 16, 3 layers with one dense, 4-8 experts), weights from a numpy
seed, f32 compute and f32 pools on both sides. Tolerances: the MLA op
against the JAX kernel in interpret mode 1e-5 (f32, exp2 against exp and sum
order); the pool after the write exact; the MoE block and the logits within
1e-4 of the largest |value| (f32, the grouped expert sum against JAX's dense
scan over experts); greedy tokens identical.
"""

import json
import struct
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu.engine.adapters import DeepseekAdapter as JaxAdapter
from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.models import deepseek as jds
from mistralrs_tpu.models.hf_loader import load_safetensors_dir as jax_load_st
from mistralrs_tpu.ops.mla_attention import mla_decode_fused
from mistralrs_tpu.pipeline import load_pipeline as jax_load_pipeline
from mistralrs_tpu_torch.convert import from_jax_deepseek_params
from mistralrs_tpu_torch.engine.adapters import DeepseekAdapter
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models import deepseek as tds
from mistralrs_tpu_torch.models.hf_loader import load_safetensors_dir
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.mla_attention import mla_decode
from mistralrs_tpu_torch.pipeline import load_pipeline

BASE = dict(
    model_type="deepseek_v2", vocab_size=128, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    q_lora_rank=None, kv_lora_rank=128, qk_rope_head_dim=16, qk_nope_head_dim=32,
    v_head_dim=32, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
    first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000.0,
    max_position_embeddings=512,
)
# DeepSeek-V2-Lite's routing: softmax scores, raw weights, no scaling
V2 = dict(BASE, scoring_func="softmax", norm_topk_prob=False, routed_scaling_factor=1.0)
# V3's: sigmoid scores with a correction bias, group-limited top-k,
# renormalised and scaled weights; here with a q LoRA
V3 = dict(BASE, model_type="deepseek_v3", scoring_func="sigmoid", norm_topk_prob=True,
          routed_scaling_factor=1.5, n_group=2, topk_group=1, q_lora_rank=48,
          n_routed_experts=4)


def state_dict(d, seed=0):
    """A random Hugging Face DeepSeek state dict (f32 numpy) for config dict d."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return (rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    h, nh, v = d["hidden_size"], d["num_attention_heads"], d["vocab_size"]
    qk = d["qk_nope_head_dim"] + d["qk_rope_head_dim"]
    rank, mi = d["kv_lora_rank"], d["moe_intermediate_size"]
    sd = {"model.embed_tokens.weight": rng.standard_normal((v, h)).astype(np.float32),
          "model.norm.weight": norm(h), "lm_head.weight": r(v, h)}
    for i in range(d["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = norm(h)
        sd[p + "post_attention_layernorm.weight"] = norm(h)
        if d["q_lora_rank"]:
            sd[p + "self_attn.q_a_proj.weight"] = r(d["q_lora_rank"], h)
            sd[p + "self_attn.q_a_layernorm.weight"] = norm(d["q_lora_rank"])
            sd[p + "self_attn.q_b_proj.weight"] = r(nh * qk, d["q_lora_rank"])
        else:
            sd[p + "self_attn.q_proj.weight"] = r(nh * qk, h)
        sd[p + "self_attn.kv_a_proj_with_mqa.weight"] = r(rank + d["qk_rope_head_dim"], h)
        sd[p + "self_attn.kv_a_layernorm.weight"] = norm(rank)
        sd[p + "self_attn.kv_b_proj.weight"] = r(
            nh * (d["qk_nope_head_dim"] + d["v_head_dim"]), rank)
        sd[p + "self_attn.o_proj.weight"] = r(h, nh * d["v_head_dim"])
        if i >= d["first_k_dense_replace"]:
            sd[p + "mlp.gate.weight"] = r(d["n_routed_experts"], h) * 4
            if d["scoring_func"] == "sigmoid":
                sd[p + "mlp.gate.e_score_correction_bias"] = (
                    0.1 * rng.standard_normal(d["n_routed_experts"])).astype(np.float32)
            for e in range(d["n_routed_experts"]):
                ep = p + f"mlp.experts.{e}."
                sd[ep + "gate_proj.weight"] = r(mi, h)
                sd[ep + "up_proj.weight"] = r(mi, h)
                sd[ep + "down_proj.weight"] = r(h, mi)
            si = mi * d["n_shared_experts"]
            sp = p + "mlp.shared_experts."
            sd[sp + "gate_proj.weight"] = r(si, h)
            sd[sp + "up_proj.weight"] = r(si, h)
            sd[sp + "down_proj.weight"] = r(h, si)
        else:
            sd[p + "mlp.gate_proj.weight"] = r(d["intermediate_size"], h)
            sd[p + "mlp.up_proj.weight"] = r(d["intermediate_size"], h)
            sd[p + "mlp.down_proj.weight"] = r(h, d["intermediate_size"])
    return sd


def both(d, seed=0):
    """(JAX cfg, JAX absorbed weights, port cfg, port weights via
    from_jax_deepseek_params), f32."""
    sd = state_dict(d, seed)
    jcfg = jds.DeepseekConfig.from_hf(d)
    jw = jds.deepseek_weights_from_state_dict(sd, jcfg, absorbed=True)
    cfg = tds.DeepseekConfig.from_hf(d)
    tw = from_jax_deepseek_params(jax.tree_util.tree_map(np.asarray, jw), cfg,
                                  device="cpu", dtype=torch.float32)
    return jcfg, jw, cfg, tw


def close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, (np.abs(got - ref).max(), scale)


# ---------------------------------------------------------------------------
# the MLA decode op
# ---------------------------------------------------------------------------


def test_mla_decode_plain_matches_pallas_interpret():
    """Output, the pool after the fused write (a dropped slot, a row with
    kv_len 0, a write into the last block of a multi-block walk) and the
    untouched layer, against the JAX kernel in interpret mode. The JAX side
    pads rows to 256 lanes; the port's rows are exactly rank + rope."""
    rng = np.random.default_rng(7)
    b, nh, rank, rope, bs, n_layers, w = 4, 4, 128, 16, 16, 2, 4
    d, d_pad = rank + rope, 256
    s = (b * w + 1) * bs
    bt = (1 + np.arange(b * w, dtype=np.int32)).reshape(b, w)
    kv_lens = np.array([37, 64, 1, 0], np.int32)
    pool = np.zeros((n_layers, s, d), np.float32)
    for i in range(b):
        for p in range(max(kv_lens[i] - 1, 0)):
            pool[:, bt[i, p // bs] * bs + p % bs] = rng.standard_normal(d) * 0.3
    slots = np.array([bt[0, 36 // bs] * bs + 36 % bs, -1, bt[2, 0] * bs,
                      bt[3, 0] * bs + 5], np.int32)
    q = (rng.standard_normal((b, nh, d)) * 0.5).astype(np.float32)
    rows = (rng.standard_normal((b, d)) * 0.3).astype(np.float32)

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, d_pad - d)])

    for layer in range(n_layers):
        out_j, pool_j = mla_decode_fused(
            jnp.asarray(pad(q)), jnp.asarray(pad(pool)), jnp.asarray(pad(rows)),
            jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens), layer, rank=rank,
            block_size=bs, scale=0.17, chunk=2, interpret=True)
        tp = torch.from_numpy(pool.copy())
        reset_counts()
        out_t = mla_decode(torch.from_numpy(q), tp, torch.from_numpy(rows),
                           torch.from_numpy(slots), torch.from_numpy(bt),
                           torch.from_numpy(kv_lens), layer, rank=rank, block_size=bs,
                           scale=0.17)
        assert COUNTS["mla_decode_plain"] == 1 and COUNTS["mla_decode"] == 0
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
        assert np.all(out_t[3].numpy() == 0)  # kv_len 0: zeros, not NaN
        np.testing.assert_array_equal(tp.numpy(), np.asarray(pool_j)[..., :d])
        assert np.all(tp.numpy()[1 - layer] == pool[1 - layer])
        np.testing.assert_array_equal(tp.numpy()[layer, s - 1], rows[1])  # the trash row


# ---------------------------------------------------------------------------
# the router and the MoE block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [V2, V3], ids=["v2_softmax", "v3_sigmoid_groups"])
def test_moe_matches_jax(d):
    jcfg, jw, cfg, tw = both(d, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 5, d["hidden_size"])).astype(np.float32)
    jlw = jax.tree_util.tree_map(lambda a: a[0], jw["segments"]["moe"])
    ref = jds._moe(jcfg, jlw, jnp.asarray(x), None)
    reset_counts()
    got = tds._moe(cfg, tw["layers"][1], torch.from_numpy(x))
    close(got.numpy(), np.asarray(ref), 1e-5)
    assert COUNTS["dense_matmul_g_plain"] == 2  # gate/up fused, then down


def test_route_v3_group_limited():
    """The V3 router keeps every choice inside the best group, weights the
    raw sigmoid scores, renormalises and scales them."""
    cfg = tds.DeepseekConfig.from_hf(V3)
    logits = torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
    topw, topi = tds.route(cfg, logits)
    assert ((topi // 2) == (topi[:, :1] // 2)).all()  # both in one group of 2
    torch.testing.assert_close(topw.sum(-1), torch.full((6,), 1.5))


# ---------------------------------------------------------------------------
# the decoder over the paged latent pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [V2, V3], ids=["no_q_lora", "q_lora"])
def test_forward_paged_matches_jax(d):
    """A 2 x 13-token prefill chunk (row 1 padded from 9 valid tokens), then
    4 decode steps with a padding row (slot -1, kv_len 0), over shuffled
    block tables: logits within 1e-4 of the largest, greedy tokens equal."""
    jcfg, jw, cfg, tw = both(d, seed=3)
    bs, nb, t = 4, 24, 13
    rng = np.random.default_rng(4)
    ids = rng.integers(0, d["vocab_size"], (2, t + 4))
    bt = rng.permutation(nb)[:18].astype(np.int32).reshape(3, 6)
    n_valid = np.array([t, 9])
    jcache = jds.make_paged_cache(jcfg, nb, bs, dtype=jnp.float32)
    tcache = tds.make_paged_cache(cfg, nb, bs, dtype=torch.float32, device="cpu")

    def slot(row, p):
        return bt[row, p // bs] * bs + p % bs

    pos = np.tile(np.arange(t), (2, 1))
    sl = np.array([[slot(r, p) if p < n_valid[r] else -1 for p in range(t)] for r in range(2)],
                  np.int32)
    steps = [(ids[:, :t], pos, bt[:2], sl, n_valid.astype(np.int32), n_valid - 1)]
    lens = n_valid.copy()
    for k in range(4):
        tok = np.array([[ids[0, t + k]], [ids[1, t + k]], [0]])
        p = np.array([[lens[0]], [lens[1]], [0]])
        s = np.array([[slot(0, lens[0])], [slot(1, lens[1])], [-1]], np.int32)
        lens = lens + 1
        steps.append((tok, p, bt, s, np.array([lens[0], lens[1], 0], np.int32), None))
    for step, (i, p, b_, s, kv, last) in enumerate(steps):
        jl, jcache = jds.deepseek_forward_paged(
            jw, jcfg, jnp.asarray(i, jnp.int32), jnp.asarray(p, jnp.int32), jcache,
            jnp.asarray(b_), jnp.asarray(s.reshape(-1)), jnp.asarray(kv), block_size=bs,
            backend="xla", compute_dtype=jnp.float32,
            last_indices=None if last is None else jnp.asarray(last, jnp.int32))
        tl, tcache = tds.deepseek_forward_paged(
            tw, cfg, torch.from_numpy(i), torch.from_numpy(p), tcache, torch.from_numpy(b_),
            torch.from_numpy(s), torch.from_numpy(kv), block_size=bs,
            compute_dtype=torch.float32,
            last_indices=None if last is None else torch.from_numpy(last))
        jl = np.asarray(jl)[:2]
        close(tl.numpy()[:2], jl)
        assert (tl.numpy()[:2, -1].argmax(-1) == jl[:, -1].argmax(-1)).all(), step


def test_weights_from_state_dict_match_the_converter():
    """The port's HF loader and ``from_jax_deepseek_params`` build the same
    weights from one state dict."""
    sd = state_dict(V3, seed=5)
    _, _, cfg, tw = both(V3, seed=5)
    lw = tds.deepseek_weights_from_state_dict(sd, cfg, dtype=torch.float32, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(lw), jax.tree_util.tree_leaves(tw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_greedy_matches_jax():
    """Both engines serve 3 greedy requests (44-50 prompt tokens) in
    16-token prefill chunks from a 12-block pool that cannot hold them all:
    the scheduler preempts and recomputes, and the tokens stay identical."""
    jcfg, jw, cfg, tw = both(V2, seed=6)
    kw = dict(num_blocks=12, block_size=16, max_batch=4, prefill_chunk=16, max_model_len=256)
    je = JaxEngine(jcfg, jw, adapter=JaxAdapter(jcfg, jw), backend="xla",
                   compute_dtype=jnp.float32, **kw)
    te = Engine(cfg, None, adapter=DeepseekAdapter(cfg, tw, compute_dtype=torch.float32,
                                                   device="cpu"), device="cpu", **kw)
    rng = np.random.default_rng(8)
    prompts = [[int(x) for x in rng.integers(0, 128, 44 + 3 * i)] for i in range(3)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=30)) for p in prompts]
    reset_counts()
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=30)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert te.stats["preemptions"] > 0
    assert te.stats["prefill_steps"] >= 9  # the prompts took several chunks each
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 30 for s in ts)
    assert COUNTS["mla_decode_plain"] > 0 and COUNTS["dense_matmul_g_plain"] > 0


def test_engine_refuses_quantized_pool():
    """The engine refuses ``kv_quant`` only where it cannot serve it: an
    adapter without ``supports_kv_quant``, or an unknown code type. The
    DeepSeek adapter's 1-byte latent pool is created (codes and a bf16
    scale per (layer, slot)) and served."""
    _, _, cfg, tw = both(V2)
    ad = DeepseekAdapter(cfg, tw, compute_dtype=torch.float32, device="cpu")

    class NoQuant(DeepseekAdapter):
        supports_kv_quant = False

    with pytest.raises(NotImplementedError):
        Engine(cfg, None, adapter=NoQuant(cfg, tw, compute_dtype=torch.float32, device="cpu"),
               device="cpu", kv_quant="int8")
    with pytest.raises(ValueError):
        tds.make_paged_cache(cfg, 4, 16, kv_quant="int4", device="cpu")
    cache = tds.make_paged_cache(cfg, 4, 16, kv_quant="int8", device="cpu")
    assert cache.pool.dtype == torch.int8 and cache.pool.shape == (3, 80, cfg.row_dim)
    assert cache.scale.dtype == torch.bfloat16 and cache.scale.shape == (3, 80)
    te = Engine(cfg, None, adapter=ad, device="cpu", kv_quant="int8", num_blocks=8,
                block_size=16, max_batch=2)
    assert te.cache.quantized and te.cache.pool.dtype == torch.int8
    seq = te.add_request([5, 9, 17, 3], SamplingParams(temperature=0.0, max_tokens=4))
    te.run_to_completion()
    assert len(seq.generated_ids) == 4 and te.cache.scale.abs().sum() > 0


# ---------------------------------------------------------------------------
# safetensors and load_pipeline
# ---------------------------------------------------------------------------

_ST_CODES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16", np.dtype(np.uint8): "U8",
             np.dtype(np.int32): "I32"}


def write_safetensors(path, tensors):
    """The safetensors format by hand: an 8-byte little-endian header length,
    the JSON header, the raw little-endian data. A torch bf16 tensor is
    written as BF16."""
    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        if isinstance(a, torch.Tensor):
            raw, code, shape = a.view(torch.int16).numpy().tobytes(), "BF16", list(a.shape)
        else:
            raw, code, shape = np.ascontiguousarray(a).tobytes(), _ST_CODES[a.dtype], list(a.shape)
        header[name] = {"dtype": code, "shape": shape, "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_load_safetensors_dir(tmp_path):
    """F32, F16 and BF16 tensors in one file, then the same split over a
    2-shard index: the values come back exactly (BF16 as bf16), and the F32
    and F16 ones as the JAX loader (the ``safetensors`` package) reads them."""
    rng = np.random.default_rng(9)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    f16 = rng.standard_normal((4,)).astype(np.float16)
    bf = torch.from_numpy(rng.standard_normal((2, 3, 2)).astype(np.float32)).to(torch.bfloat16)
    one = tmp_path / "one"
    one.mkdir()
    write_safetensors(one / "model.safetensors", {"a.f32": f32, "b.f16": f16, "c.bf16": bf})
    got = load_safetensors_dir(one)
    assert set(got) == {"a.f32", "b.f16", "c.bf16"}
    assert got["a.f32"].dtype == torch.float32 and got["b.f16"].dtype == torch.float16
    assert got["c.bf16"].dtype == torch.bfloat16 and torch.equal(got["c.bf16"], bf)
    np.testing.assert_array_equal(got["a.f32"].numpy(), f32)
    np.testing.assert_array_equal(got["b.f16"].numpy(), f16)
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    write_safetensors(sharded / "model-00001-of-00002.safetensors", {"a.f32": f32})
    write_safetensors(sharded / "model-00002-of-00002.safetensors", {"b.f16": f16})
    (sharded / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
        "a.f32": "model-00001-of-00002.safetensors",
        "b.f16": "model-00002-of-00002.safetensors"}}))
    got2 = load_safetensors_dir(sharded)
    assert set(got2) == {"a.f32", "b.f16"}
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(tmp_path)
    pytest.importorskip("safetensors")  # the JAX loader reads through it
    ref = jax_load_st(sharded)
    assert set(got2) == set(ref) == {"a.f32", "b.f16"}
    for k in ref:
        np.testing.assert_array_equal(got2[k].numpy(), np.asarray(ref[k]))


def test_load_pipeline_deepseek_dir_matches_jax(tmp_path):
    """A tiny DeepSeek-V2 HF directory (config.json with a YaRN entry, which
    both packages ignore, and one safetensors file) through both
    ``load_pipeline``s: the port's adapter prefill gives JAX's logits."""
    d = dict(V2, rope_scaling={"type": "yarn", "factor": 40,
                               "original_max_position_embeddings": 4096})
    sd = state_dict(d, seed=10)
    (tmp_path / "config.json").write_text(json.dumps(d))
    write_safetensors(tmp_path / "model.safetensors", sd)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    jpipe = jax_load_pipeline(str(tmp_path))
    assert pipe.adapter is not None and pipe.tokenizer is None
    assert pipe.model_id == tmp_path.name
    ids = np.random.default_rng(11).integers(0, 128, (1, 11))
    bt = np.arange(3, dtype=np.int32)[None]
    slots = np.arange(11, dtype=np.int32)[None]
    kv = np.array([11], np.int32)
    jl, _ = jds.deepseek_forward_paged(
        jpipe.weights, jpipe.cfg, jnp.asarray(ids, jnp.int32),
        jnp.arange(11, dtype=jnp.int32)[None], jds.make_paged_cache(jpipe.cfg, 3, 4),
        jnp.asarray(bt), jnp.asarray(slots[0]), jnp.asarray(kv), block_size=4, backend="xla")
    ad = pipe.adapter
    cache = ad.create_cache(3, 4, 1)
    tl, _ = ad.prefill(cache, torch.from_numpy(ids), torch.arange(11)[None],
                       torch.from_numpy(bt), torch.from_numpy(slots), torch.from_numpy(kv),
                       torch.tensor([10]))
    close(tl.numpy(), np.asarray(jl))


def test_cli_serves_deepseek_dir(tmp_path):
    """``cli serve DIR`` on a tiny DeepSeek-V2 directory with a WordLevel
    ``tokenizer.json``: the server answers a greedy chat request, sized its
    latent pool from the adapter, and stops at the config's EOS id or at
    ``max_tokens``."""
    tokenizers = pytest.importorskip("tokenizers")
    d = dict(V2, eos_token_id=1)
    (tmp_path / "config.json").write_text(json.dumps(d))
    write_safetensors(tmp_path / "model.safetensors", state_dict(d, seed=13))
    vocab = {f"w{i}": i for i in range(128)}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="w0"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mistralrs_tpu_torch.cli", "serve", str(tmp_path), "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "256"],
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
        choice = out["choices"][0]
        assert choice["finish_reason"] in ("stop", "length")
        assert 1 <= out["usage"]["completion_tokens"] <= 6
        assert all(w.startswith("w") for w in choice["message"]["content"].split())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
