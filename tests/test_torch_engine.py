"""The port's continuous-batching ``Engine(device="cpu")`` against the JAX
``Engine(backend="xla")`` on the same tiny model: greedy tokens must be
identical, through batched prefill, chunked prefill, prefix-cache hits and
forced preemption. Both engines run f32 compute and f32 KV pools, where the
two packages agree to ~1e-6 (see test_torch_llama.py), so greedy arg-maxes
do not flip on rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.models import ModelConfig as JaxConfig
from mistralrs_tpu.models import init_random_weights as jax_init
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.sequence import StopReason
from mistralrs_tpu_torch.kv.paged import calculate_cache_config
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts

from test_torch_moe import MIXED, MOE_KW, _jax_moe_weights, jax_to_numpy

CFG_KW = dict(
    arch="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=512,
)
JCFG = JaxConfig(**CFG_KW)
CFG = ModelConfig(**CFG_KW)
JW = jax_init(JCFG, seed=7, dtype=jnp.float32, scale=0.1)
TW = from_jax_params(
    {k: (None if v is None else
         {kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
         else np.asarray(v)) for k, v in JW.items()},
    CFG, device="cpu", dtype=torch.float32,
)


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 256, length + 3 * i)] for i in range(n)]


def _run(engine_kw, prompts, max_tokens):
    """Greedy outputs of both engines → (jax, port, jax engine, port engine)."""
    je = JaxEngine(JCFG, JW, backend="xla", compute_dtype=jnp.float32, **engine_kw)
    te = Engine(CFG, TW, compute_dtype=torch.float32, device="cpu", **engine_kw)
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=max_tokens))
          for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
          for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    return [s.generated_ids for s in js], [s.generated_ids for s in ts], je, te


def test_batched_greedy_matches_jax():
    j, t, _, te = _run(dict(num_blocks=64, block_size=16, max_batch=4),
                       _prompts(4, 5), max_tokens=6)
    assert t == j
    assert all(len(x) == 6 for x in t)
    assert te.stats["generated_tokens"] == 24


def test_chunked_prefill_matches_jax():
    """A 50-token prompt in 16-token chunks, next to a short one."""
    prompts = [_prompts(1, 50, seed=1)[0], [3, 1, 4, 1, 5]]
    j, t, _, te = _run(dict(num_blocks=128, block_size=16, max_batch=4,
                            prefill_chunk=16), prompts, max_tokens=5)
    assert t == j
    assert te.stats["prefill_steps"] >= 4  # 50 tokens took several chunks


def test_forced_preemption_matches_jax():
    """A 9-block pool cannot hold three 60-token sequences: the scheduler
    preempts and recomputes, and the tokens still match the JAX engine's."""
    j, t, je, te = _run(dict(num_blocks=9, block_size=16, max_batch=4),
                        _prompts(3, 20, seed=2), max_tokens=40)
    assert te.stats["preemptions"] > 0
    assert te.stats["preemptions"] == je.stats["preemptions"]
    assert t == j
    assert all(len(x) == 40 for x in t)


def test_prefix_cache_hit_reuses_blocks():
    te = Engine(CFG, TW, compute_dtype=torch.float32, device="cpu",
                num_blocks=64, block_size=16, max_batch=4)
    prompt = _prompts(1, 40, seed=3)[0]
    s1 = te.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=4))
    te.run_to_completion()
    s2 = te.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=4))
    te.run_to_completion()
    assert te.stats["prefix_cache_hit_tokens"] >= 32
    assert s2.output_ids == s1.output_ids


def test_seeded_sampling_is_reproducible_and_stops():
    """Sampled rows draw from per-request generators: the same seed gives
    the same tokens whatever else is in the batch; stop tokens end a row."""
    te = Engine(CFG, TW, device="cpu", num_blocks=64, block_size=16, max_batch=4)
    p = SamplingParams(temperature=0.9, top_k=50, top_p=0.9, min_p=0.01, seed=11,
                       max_tokens=8)
    a = te.add_request([5, 6, 7], p)
    te.add_request([9, 9, 9, 9], SamplingParams(temperature=1.0, seed=3, max_tokens=8))
    te.run_to_completion()
    b = te.add_request([5, 6, 7], p)
    te.run_to_completion()
    assert a.output_ids == b.output_ids and len(a.output_ids) == 8
    stop = a.output_ids[2]
    c = te.add_request([5, 6, 7], SamplingParams(temperature=0.9, top_k=50, top_p=0.9,
                                                 min_p=0.01, seed=11, max_tokens=8,
                                                 stop_token_ids=(stop,)))
    te.run_to_completion()
    assert c.stop_reason == StopReason.STOP_TOKEN
    assert c.output_ids[-1] == stop and len(c.output_ids) <= 3


def test_unported_features_raise():
    """What still refuses: a constraint string the engine does not know, and
    any constraint on an engine with no tokenizer to build its masks."""
    te = Engine(CFG, TW, device="cpu", num_blocks=16, block_size=16, max_batch=2)
    with pytest.raises(ValueError, match="unknown constraint"):
        te.add_request([1, 2], SamplingParams(constraint="xml"))
    with pytest.raises(ValueError, match="require a tokenizer"):
        te.add_request([1, 2], SamplingParams(constraint="json_object"))
    assert not te.has_work


def test_cache_config_sizes_from_memory():
    """Blocks fill the memory left after the weights, clamped to [2 blocks
    per sequence, full length for max_batch sequences]; the +1 trash block
    is reserved."""
    per_block = 2 * CFG.num_layers * CFG.num_kv_heads * CFG.head_dim * 2 * 16
    n = calculate_cache_config(CFG, block_size=16, max_model_len=512, max_batch=4,
                               mem_bytes=100 * per_block, weight_bytes=20 * per_block,
                               utilization=0.5, device="cpu")
    assert n == 39  # 0.5 * 80 blocks, minus the trash block
    assert calculate_cache_config(CFG, block_size=16, max_model_len=512, max_batch=4,
                                  mem_bytes=10**12, device="cpu") == 128  # 32 blocks x 4
    assert calculate_cache_config(CFG, block_size=16, max_model_len=512, max_batch=4,
                                  mem_bytes=per_block, device="cpu") == 8  # 2 x 4
    with pytest.raises(ValueError):
        calculate_cache_config(CFG, max_model_len=512, max_batch=4, device="cpu")


def test_tiny_mixtral_greedy_matches_jax():
    """The 2-layer Mixtral of test_torch_moe.py (Q4_K gate/up, Q6_K down
    banks, 4 experts, top-2) served by both engines: greedy tokens are
    identical through a batched prefill and decode, and the port's grouped
    path ran (its plain versions, on the CPU)."""
    kw = dict(MOE_KW, arch="mixtral")
    jcfg, jw = _jax_moe_weights(kw, [MIXED, MIXED], seed=21)
    cfg = ModelConfig(**kw)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    engine_kw = dict(num_blocks=32, block_size=16, max_batch=4)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **engine_kw)
    te = Engine(cfg, tw, compute_dtype=torch.float32, device="cpu", **engine_kw)
    prompts = _prompts(3, 7, seed=5)
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=5)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=5)) for p in prompts]
    je.run_to_completion()
    reset_counts()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 5 for s in ts)
    assert COUNTS["w4_matmul_g_plain"] > 0 and COUNTS["w8_matmul_g_plain"] > 0


def test_prefill_chunk_over_1024_is_served():
    """A 1475-token prompt in one 2048-token prefill chunk (past the largest
    of the JAX package's buckets, 1024) is served, and its greedy tokens
    equal those of 512-token chunks."""
    kw = dict(CFG_KW, num_layers=1, max_position_embeddings=2048)
    cfg = ModelConfig(**kw)
    w = from_jax_params(
        {k: (None if v is None else
             {kk: np.asarray(vv)[:1] for kk, vv in v.items()} if isinstance(v, dict)
             else np.asarray(v)) for k, v in JW.items()},
        cfg, device="cpu", dtype=torch.float32,
    )
    prompt = [int(x) for x in np.random.default_rng(12).integers(0, 256, 1475)]
    outs = []
    for chunk in (2048, 512):
        te = Engine(cfg, w, compute_dtype=torch.float32, device="cpu", num_blocks=100,
                    block_size=16, max_batch=2, max_model_len=2048, prefill_chunk=chunk)
        s = te.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=4))
        te.run_to_completion()
        assert s.stop_reason == StopReason.LENGTH, getattr(s, "error", None)
        assert te.stats["prefill_steps"] == (1 if chunk == 2048 else 3)
        outs.append(s.output_ids)
    assert outs[0] == outs[1] and len(outs[0]) == 4
