"""The contiguous-cache path of the port on the CPU, held against the JAX
package (its XLA path: ``backend=None`` on the CPU) on inputs drawn with
numpy from a seed, weights carried across by ``convert.from_jax_params``.

* ``ops/attention.py::sdpa`` with each mask option, sinks, ring slot
  positions and a query row that sees no key (f32, 1e-6).
* ``models/llama.py::forward`` over ``KVCache``: a prefill, a chunk at
  unequal row offsets and decode steps, for llama quantized in situ to
  Q4_K, Gemma-2 (windows, softcaps, post norms), gpt-oss (sinks), Mixtral
  (Q4_K/Q6_K experts) and Phi-2 (parallel residual, gateless MLP,
  LayerNorm, partial rotary); ``RotatingKVCache`` and ``HybridKVCache``
  across a wrapped window, a chunk longer than the window included.
* ``ImatrixCollector``, ``generate`` (greedy, all three cache types; the
  sampler's draws by distribution), ``compute_perplexity``, ``embed`` and
  the ``imatrix`` and ``perplexity`` commands.
* The two faults of the reference that the port does not copy (ROADMAP
  Queue 3 items 11-12): ring caches drop gpt-oss's sinks (the port refuses
  them), ``_write_kv`` clamps a write past the capacity (the port raises).

Tolerances: f32 dense weights within rtol/atol 1e-4 of JAX's logits (f32
sum order); quantized weights within 1e-2 of the largest logit (both
packages round the activations entering each quantized product to bf16, so
a last-bit f32 difference can move one rounding, as the earlier quantized
slices' tests note); ring caches against JAX's within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu import cli as jax_cli
from mistralrs_tpu.embeddings import embed as jax_embed
from mistralrs_tpu.generate import _freeze
from mistralrs_tpu.generate import generate as jax_generate
from mistralrs_tpu.imatrix import ImatrixCollector as JaxCollector
from mistralrs_tpu.gguf.constants import GGMLType as JaxGGMLType
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import weights_from_state_dict as jax_wfsd
from mistralrs_tpu.models.llama import HybridKVCache as JaxHybrid
from mistralrs_tpu.models.llama import KVCache as JaxKVCache
from mistralrs_tpu.models.llama import RotatingKVCache as JaxRotating
from mistralrs_tpu.models.llama import _write_kv as jax_write_kv
from mistralrs_tpu.models.llama import forward as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.ops.attention import sdpa as jax_sdpa
from mistralrs_tpu.perplexity import compute_perplexity as jax_perplexity
from mistralrs_tpu_torch import cli
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.embeddings import embed
from mistralrs_tpu_torch.generate import generate, sample
from mistralrs_tpu_torch.imatrix import ImatrixCollector, load_imatrix
from mistralrs_tpu_torch.kv.contiguous import (
    HybridKVCache,
    KVCache,
    RotatingKVCache,
    hybrid_layer_maps,
    write_kv,
)
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import forward, fuse_projections
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.attention import sdpa
from mistralrs_tpu_torch.perplexity import compute_perplexity

from test_torch_gemma2 import GEMMA_KW, _gemma_weights
from test_torch_gpt_oss import _jax_weights as _gpt_oss_weights
from test_torch_gpt_oss import _kw as _gpt_oss_kw
from test_torch_isq import _case, _write_dir
from test_torch_llama import CFG_KW, jax_to_numpy
from test_torch_moe import MIXED, MOE_KW, _jax_moe_weights

F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """ISQ's quantizers (the Q4_K llama, the commands' ``--compare-isq``)
    and the tiny models run many small torch ops: beside the suite's other
    workers an intra-op thread pool spends each of them waiting on its
    threads (this file took 396 worker-seconds in a 6-worker run of the
    suite, 55 s alone), so they run on one thread here, as in
    ``tests/test_torch_isq.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jw, cfg, dtype=torch.float32):
    return from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=dtype)


# ---------------------------------------------------------------------------
# sdpa
# ---------------------------------------------------------------------------

SDPA_CASES = {
    "kv_len": {},
    "window": dict(sliding_window=3),
    "softcap": dict(logit_softcap=5.0),
    "sinks": dict(sinks=True),
    "all": dict(sliding_window=4, logit_softcap=5.0, sinks=True),
    "ring": dict(ring=True, sliding_window=6),
    "no_key": dict(no_key=True),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_matches_jax(case):
    """GQA group 2 over an over-allocated buffer (kv_lens 9 and 12 of 16),
    queries at the buffer's last positions; ``ring``: slot positions of a
    ring with empty (-1) slots; ``no_key``: a row whose query sees no key
    (kv_len 0), where both give the mean of V, not NaN. f32 within 1e-6."""
    opts = dict(SDPA_CASES[case])
    rng = np.random.default_rng(list(SDPA_CASES).index(case))
    b, t, s, n_q, n_kv, hd = 2, 4, 16, 4, 2, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * 2
               for shape in ((b, t, n_q, hd), (b, s, n_kv, hd), (b, s, n_kv, hd)))
    kv_len = np.asarray([9, 0 if opts.pop("no_key", False) else 12], np.int32)
    qpos = (kv_len[:, None] - t + np.arange(t)[None]).clip(0).astype(np.int32)
    kw = {}
    if opts.pop("sinks", False):
        kw["sinks"] = rng.standard_normal(n_q).astype(np.float32)
    if opts.pop("ring", False):
        kvp = np.stack([rng.permutation(s) + 3 for _ in range(b)]).astype(np.int32)
        kvp[:, ::5] = -1
        kw["kv_positions"] = kvp
        qpos = np.full((b, t), 14, np.int32) + np.arange(t)
    kw.update(opts)
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_positions=jnp.asarray(qpos), kv_len=jnp.asarray(kv_len),
                               **{x: jnp.asarray(y) if isinstance(y, np.ndarray) else y
                                  for x, y in kw.items()}))
    got = sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               q_positions=torch.from_numpy(qpos), kv_len=torch.from_numpy(kv_len),
               **{x: torch.from_numpy(y) if isinstance(y, np.ndarray) else y
                  for x, y in kw.items()}).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if case == "no_key":  # no key seen: the mean of the row's V over the buffer
        mean = v[1].mean(axis=0)  # [n_kv, hd]
        np.testing.assert_allclose(got[1, :, ::2], np.broadcast_to(mean, (t, n_kv, hd)),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# forward over the contiguous caches
# ---------------------------------------------------------------------------


def _phi2_weights(seed=5):
    """A tiny Phi-2: LayerNorm with biases, partial rotary (0.5), gelu_new,
    a gateless biased MLP, the parallel residual (no ffn norm), q/k/v/o
    biases, an untied head with its bias."""
    kw = dict(CFG_KW, arch="phi2", norm_type="layernorm", parallel_residual=True,
              partial_rotary_factor=0.5, hidden_act="gelu_new", rms_norm_eps=1e-5)
    jcfg = JaxConfig(**kw)
    jw = jax_init(jcfg, seed=seed, dtype=jnp.float32, scale=0.1)
    rng = np.random.default_rng(seed)
    nl, h, i = kw["num_layers"], kw["hidden_size"], kw["intermediate_size"]

    def r(*shape, s=0.1):
        return jnp.asarray(rng.standard_normal(shape) * s, jnp.float32)

    layers = {k: v for k, v in jw["layers"].items() if k not in ("gate", "ffn_norm")}
    layers.update(attn_norm_bias=r(nl, h), wq_bias=r(nl, jcfg.q_dim), wk_bias=r(nl, jcfg.kv_dim),
                  wv_bias=r(nl, jcfg.kv_dim), wo_bias=r(nl, h), up_bias=r(nl, i),
                  down_bias=r(nl, h))
    return kw, {**jw, "layers": layers, "final_norm_bias": r(h), "lm_head_bias": r(kw["vocab_size"])}


def _llama_q4k():
    """The tiny llama of ``tests/test_torch_isq.py`` quantized in situ to
    Q4_K with an imatrix by the JAX package, carried across (that file
    holds the port's own ISQ bit-equal to it)."""
    hf_cfg, sd, im = _case("llama_q4k_imatrix", seed=4)
    jcfg, cfg = jax_config_from_hf(hf_cfg), config_from_hf(hf_cfg)
    jw = jax_wfsd(sd, jcfg, dtype=jnp.float32, isq=JaxGGMLType.Q4_K, imatrix=im)
    return jcfg, jw, cfg, _port(jw, cfg)


def _models():
    """name → (JAX config, JAX weights, port config, port weights, f32 tol)."""
    out = {}
    jcfg, jw, cfg, tw = _llama_q4k()
    out["llama_q4k"] = (jcfg, jw, cfg, tw, "quant")
    jcfg, cfg = JaxConfig(**GEMMA_KW), ModelConfig(**GEMMA_KW)
    jw = _gemma_weights(jcfg, 3, jnp.float32)
    out["gemma2"] = (jcfg, jw, cfg, _port(jw, cfg), "f32")
    kw = _gpt_oss_kw(16)
    jcfg, jw = _gpt_oss_weights(kw, 3, jnp.float32)
    cfg = ModelConfig(**kw)
    out["gpt_oss"] = (jcfg, jw, cfg, fuse_projections(_port(jw, cfg), cfg), "f32")
    kw = dict(MOE_KW, arch="mixtral")
    jcfg, jw = _jax_moe_weights(kw, [MIXED, MIXED])
    cfg = ModelConfig(**kw)
    out["mixtral"] = (jcfg, jw, cfg, _port(jw, cfg), "quant")
    kw, jw = _phi2_weights()
    out["phi2"] = (JaxConfig(**kw), jw, ModelConfig(**kw), _port(jw, ModelConfig(**kw)), "f32")
    return out


MODELS = ("llama_q4k", "gemma2", "gpt_oss", "mixtral", "phi2")


@pytest.fixture(scope="module")
def models():
    return _models()


def _steps(vocab, seed=0):
    """(ids, positions, kv_start) of each forward: a 10-token prefill of two
    rows, then 4 decode steps, the rows at unequal offsets (row 1 from 7:
    it rewrites its positions 7-9). Two shapes, so JAX traces twice."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 14))
    steps = [(toks[:, :10], np.tile(np.arange(10), (2, 1)), np.asarray([0, 0]))]
    for d in range(4):
        starts = np.asarray([10, 7]) + d
        steps.append((toks[:, 10 + d:11 + d], starts[:, None], starts))
    return [(i.astype(np.int32), p.astype(np.int32), s.astype(np.int32)) for i, p, s in steps]


def _close(got, want, tol):
    assert got.shape == want.shape and np.isfinite(got).all()
    if tol == "quant":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **(F32 if tol == "f32" else tol))


# JAX forward, jitted: one trace a shape where the bare call traces its
# layer scan at every call
_jax_forward_jit = jax.jit(jax_forward, static_argnames=(
    "cfg", "compute_dtype", "logits_last_only", "return_hidden"))


def _both_forward(model, jcache, tcache, steps, **fkw):
    jcfg, jw, cfg, tw, tol = model
    for n, (ids, pos, starts) in enumerate(steps):
        jl, jcache = _jax_forward_jit(jw, _freeze(jcfg), jnp.asarray(ids), jnp.asarray(pos),
                                      jcache, jnp.asarray(starts), compute_dtype=jnp.float32,
                                      **fkw)
        tl, tcache = forward(tw, cfg, torch.from_numpy(ids).long(), torch.from_numpy(pos),
                             tcache, starts.tolist(), compute_dtype=torch.float32, **fkw)
        _close(tl.numpy(), np.asarray(jl), tol)
    return jcache, tcache


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(models, name):
    """Every step's logits against JAX ``forward`` over ``KVCache`` (module
    docstring's tolerances), the last step with ``logits_last_only``; the
    caches' K/V equal to JAX's but where row 1's rewrite makes both hold
    its last write."""
    model = models[name]
    jcfg, _, cfg, _, tol = model
    steps = _steps(cfg.vocab_size)
    jc, tc = _both_forward(model, JaxKVCache.create(jcfg, 2, 16, dtype=jnp.float32),
                           KVCache.create(cfg, 2, 16, dtype=torch.float32, device="cpu"),
                           steps[:-1])
    jc, tc = _both_forward(model, jc, tc, steps[-1:], logits_last_only=True)
    atol = 1e-4 if tol == "f32" else 2e-2
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0, atol=atol)


def _window_steps(vocab, chunks, n_dec=3, seed=1):
    rng = np.random.default_rng(seed)
    total = sum(chunks) + n_dec
    toks = rng.integers(0, vocab, (2, total)).astype(np.int32)
    steps, p = [], 0
    for c in list(chunks) + [1] * n_dec:
        pos = np.tile(np.arange(p, p + c, dtype=np.int32), (2, 1))
        steps.append((toks[:, p:p + c], pos, np.full(2, p, np.int32)))
        p += c
    return steps


def test_rotating_cache_matches_jax():
    """A uniformly sliding llama (window 8): chunks of 6 and 11 tokens
    (the second longer than the window) and 3 decode steps through
    ``RotatingKVCache`` against JAX's: logits within 1e-5, the ring and
    ``slot_pos`` equal; the same run over ``KVCache`` gives the same logits
    (the window hides what the ring dropped)."""
    kw = dict(CFG_KW, sliding_window=8)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jw = jax_init(jcfg, seed=2, dtype=jnp.float32, scale=0.1)
    model = (jcfg, jw, cfg, _port(jw, cfg), dict(rtol=1e-5, atol=1e-5))
    steps = _window_steps(cfg.vocab_size, (6, 11))
    jc, tc = _both_forward(model, JaxRotating.create(jcfg, 2, dtype=jnp.float32),
                           RotatingKVCache.create(cfg, 2, dtype=torch.float32, device="cpu"),
                           steps)
    assert tc.slot_pos.tolist() == np.asarray(jc.slot_pos).tolist()
    assert sorted(tc.slot_pos[0].tolist()) == list(range(12, 20))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-5, atol=1e-5)
    full = KVCache.create(cfg, 2, 20, dtype=torch.float32, device="cpu")
    ring = RotatingKVCache.create(cfg, 2, dtype=torch.float32, device="cpu")
    for ids, pos, starts in steps:
        args = (torch.from_numpy(ids).long(), torch.from_numpy(pos))
        a, full = forward(model[3], cfg, *args, full, starts.tolist(), compute_dtype=torch.float32)
        b, ring = forward(model[3], cfg, *args, ring, starts.tolist(), compute_dtype=torch.float32)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_hybrid_cache_matches_jax(models):
    """Gemma-2 (sliding window 8 on layers 0 and 2, full on 1 and 3):
    two chunks of 9 tokens (longer than the window) and 3 decode steps through
    ``HybridKVCache`` against JAX's: logits, and both pools, within
    rtol/atol 1e-4 (f32 sum order, compounded over 4 layers), ``slot_pos``
    equal."""
    jcfg, jw, cfg, tw, _ = models["gemma2"]
    kinds, idx = hybrid_layer_maps(cfg)
    assert kinds.tolist() == [1, 0, 1, 0] and idx.tolist() == [0, 0, 1, 1]
    steps = _window_steps(cfg.vocab_size, (9, 9), seed=2)
    jc, tc = _both_forward((jcfg, jw, cfg, tw, "f32"),
                           JaxHybrid.create(jcfg, 2, 32, dtype=jnp.float32),
                           HybridKVCache.create(cfg, 2, 32, dtype=torch.float32, device="cpu"),
                           steps)
    assert tc.slot_pos.tolist() == np.asarray(jc.slot_pos).tolist()
    for key in ("k_full", "v_full", "k_win", "v_win"):
        np.testing.assert_allclose(getattr(tc, key).numpy(), np.asarray(getattr(jc, key)), **F32)


def test_forward_return_hidden_and_refusals(models):
    """``return_hidden`` gives the final-norm states [B, T, H] f32 as JAX's;
    the arguments of other ROADMAP items, ``layers_moe`` segments, imatrix
    taps over a ring cache and a cache of another kind are refused by
    name."""
    jcfg, jw, cfg, tw, _ = models["phi2"]
    ids, pos, starts = _steps(cfg.vocab_size)[0]
    jh, _ = _jax_forward_jit(jw, _freeze(jcfg), jnp.asarray(ids), jnp.asarray(pos),
                        JaxKVCache.create(jcfg, 2, 10, dtype=jnp.float32), jnp.asarray(starts),
                        compute_dtype=jnp.float32, return_hidden=True)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(pos))
    th, _ = forward(tw, cfg, *args, KVCache.create(cfg, 2, 10, dtype=torch.float32, device="cpu"),
                    [0, 0], compute_dtype=torch.float32, return_hidden=True)
    assert th.dtype == torch.float32 and th.shape == (2, 10, cfg.hidden_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    cache = KVCache.create(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for key, item in (("input_embeds", "12"), ("rope_override", "12"), ("bidirectional", "13"),
                      ("tp_axis", "11")):
        with pytest.raises(NotImplementedError, match=f"{key}.*item {item}"):
            forward(tw, cfg, *args, cache, [0, 0], **{key: True if key == "bidirectional"
                                                     else "x"})
    with pytest.raises(NotImplementedError, match="layers_moe.*item 5"):
        forward({**tw, "layers_moe": []}, cfg, *args, cache, [0, 0])
    gcfg, gtw = models["gemma2"][2], models["gemma2"][3]
    with pytest.raises(NotImplementedError, match="collect_moments"):
        forward(gtw, gcfg, *args, HybridKVCache.create(gcfg, 2, 16, device="cpu"), [0, 0],
                collect_moments=True)
    with pytest.raises(TypeError, match="unknown cache"):
        forward(tw, cfg, *args, object(), [0, 0])
    with pytest.raises(ValueError, match="window mix"):
        RotatingKVCache.create(gcfg, 2, device="cpu")


# ---------------------------------------------------------------------------
# the reference's two faults
# ---------------------------------------------------------------------------


def test_write_past_capacity_raises():
    """JAX ``_write_kv`` clamps a write past the capacity onto the buffer's
    tail (``dynamic_update_slice``: 4 tokens at offset 6 of 8 land at 4-7,
    over positions 4 and 5); the port's ``write_kv`` raises instead, and so
    does ``forward`` before it writes anything (ROADMAP Queue 3 item 12).
    Rows at unequal offsets inside the capacity are written in place as
    JAX writes them."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 8, 1, 2)).astype(np.float32)
    new = rng.standard_normal((2, 4, 1, 2)).astype(np.float32)
    clamped = np.asarray(jax_write_kv(jnp.asarray(cache), jnp.asarray(new), jnp.asarray([6, 0])))
    np.testing.assert_array_equal(clamped[0, 4:], new[0])  # written at 4, not at 6
    layer = torch.from_numpy(cache.copy())
    with pytest.raises(ValueError, match="passes the cache's capacity of 8"):
        write_kv(layer, torch.from_numpy(new), [6, 0])
    assert torch.equal(layer, torch.from_numpy(cache))
    want = np.asarray(jax_write_kv(jnp.asarray(cache), jnp.asarray(new), jnp.asarray([4, 1])))
    write_kv(layer, torch.from_numpy(new), [4, 1])
    np.testing.assert_array_equal(layer.numpy(), want)
    cfg = ModelConfig(**CFG_KW)
    w = _port(jax_init(JaxConfig(**CFG_KW), seed=0, dtype=jnp.float32), cfg)
    kv = KVCache.create(cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        forward(w, cfg, torch.zeros((1, 4), dtype=torch.long), torch.arange(6, 10)[None], kv, [6])
    assert not kv.k.any()


def test_ring_caches_refuse_sinks(models):
    """JAX's ring branch passes no sinks to ``sdpa``: over ``HybridKVCache``
    gpt-oss's sliding layers lose theirs (their sinks can be anything; the
    logits do not move), where ``KVCache`` uses them (ROADMAP Queue 3 item
    11). The port refuses both ring caches for a model with sinks."""
    jcfg, jw, cfg, tw, _ = models["gpt_oss"]
    ids, pos, starts = _steps(cfg.vocab_size)[0]

    def jax_logits(weights, cache):
        return np.asarray(_jax_forward_jit(weights, _freeze(jcfg), jnp.asarray(ids),
                                           jnp.asarray(pos), cache, jnp.asarray(starts),
                                           compute_dtype=jnp.float32)[0])

    sinks = np.asarray(jw["layers"]["sinks"]).copy()
    moved = sinks.copy()
    moved[0::2] += 5.0  # the sliding layers' sinks
    jw_moved = {**jw, "layers": {**jw["layers"], "sinks": jnp.asarray(moved)}}

    def hybrid():
        return JaxHybrid.create(jcfg, 2, 16, dtype=jnp.float32)

    np.testing.assert_array_equal(jax_logits(jw, hybrid()), jax_logits(jw_moved, hybrid()))
    full = JaxKVCache.create(jcfg, 2, 16, dtype=jnp.float32)
    assert np.abs(jax_logits(jw, full) - jax_logits(jw_moved, full)).max() > 1e-3
    args = (torch.from_numpy(ids).long(), torch.from_numpy(pos))
    with pytest.raises(NotImplementedError, match="sinks.*item 11"):
        forward(tw, cfg, *args, HybridKVCache.create(cfg, 2, 16, device="cpu"), [0, 0])
    uniform = ModelConfig(**dict(_gpt_oss_kw(16), layer_types=["sliding_attention"] * 4))
    with pytest.raises(NotImplementedError, match="sinks.*item 11"):
        forward(tw, uniform, *args, RotatingKVCache.create(uniform, 2, device="cpu"), [0, 0])


# ---------------------------------------------------------------------------
# imatrix, generate, perplexity, embed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "mixtral", "phi2"])
def test_imatrix_collector_matches_jax(models, name):
    """``finalize()`` after two batches ([2, 9] and [1, 12] tokens; one,
    [2, 9], for Mixtral and Phi-2): the same taps as JAX's (Mixtral's expert
    layers have no ``down_in``; Phi-2's ``mlp_in`` is its ``attn_in``, the
    parallel residual's one normed x), each within rtol 1e-5 (f32 sums in
    another order), and the token count."""
    if name == "llama":
        jcfg = JaxConfig(**CFG_KW)
        jw = jax_init(jcfg, seed=6, dtype=jnp.float32, scale=0.1)
        cfg, tw = ModelConfig(**CFG_KW), _port(jw, ModelConfig(**CFG_KW))
    else:
        jcfg, jw, cfg, tw, _ = models[name]
    rng = np.random.default_rng(3)
    shapes = ((2, 9), (1, 12)) if name == "llama" else ((2, 9),)
    batches = [rng.integers(0, cfg.vocab_size, shape) for shape in shapes]
    jc, tc = JaxCollector(jcfg), ImatrixCollector(cfg, device="cpu")
    for ids in batches:
        jc.update(jw, ids)
        tc.update(tw, ids)
    want, got = jc.finalize(), tc.finalize()
    assert tc.tokens == jc.tokens == sum(b * t for b, t in shapes)
    assert sorted(got) == sorted(want)
    assert ("down_in" in got) == (name != "mixtral")
    for tap in want:
        assert got[tap].dtype == np.float32 and got[tap].shape == want[tap].shape
        np.testing.assert_allclose(got[tap], want[tap], rtol=1e-5, atol=1e-9)
    if name == "phi2":
        np.testing.assert_array_equal(got["mlp_in"], got["attn_in"])


@pytest.mark.parametrize("cache_type", ["normal", "rotating", "hybrid"])
def test_generate_greedy_matches_jax(models, cache_type):
    """12 greedy tokens from a 9-token prompt, f32, equal to JAX
    ``generate``'s: llama over ``KVCache``, a uniformly sliding llama
    (window 8) over ``RotatingKVCache`` (the ring wraps), Gemma-2 over
    ``HybridKVCache``."""
    if cache_type == "hybrid":
        jcfg, jw, cfg, tw, _ = models["gemma2"]
    else:
        kw = dict(CFG_KW, sliding_window=8) if cache_type == "rotating" else CFG_KW
        jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
        jw = jax_init(jcfg, seed=8, dtype=jnp.float32, scale=0.3)
        tw = _port(jw, cfg)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 9).tolist()
    kw = dict(max_new_tokens=12, compute_dtype=jnp.float32, cache_type=cache_type,
              stop_tokens=set())
    want = jax_generate(jw, jcfg, prompt, **kw)
    got = generate(tw, cfg, prompt, **{**kw, "compute_dtype": torch.float32}, device="cpu")
    assert got == want and len(got) == 12
    stop = got[5]
    assert generate(tw, cfg, prompt, **{**kw, "compute_dtype": torch.float32,
                                        "stop_tokens": {stop}}, device="cpu") == got[:got.index(stop)]


def test_sampled_draws_follow_the_softmax():
    """Temperature sampling is compared by distribution, not by draw
    stream: 40000 draws of ``sample`` at temperature 0.7 from fixed logits
    over 6 tokens, and as many of JAX's ``jax.random.categorical``, each
    within a chi-square bound (p = 1e-4, 5 dof) of ``softmax(logits / T)``;
    a seeded ``generate`` repeats itself."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -3.0]])
    p = torch.softmax(logits[0] / 0.7, dim=0).numpy().astype(np.float64)
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = sample(logits.expand(n, 6), 0.7, gen).numpy()
    jdraws = np.asarray(jax.random.categorical(jax.random.PRNGKey(0),
                                               jnp.asarray(logits[0].numpy()) / 0.7, shape=(n,)))
    for d in (draws, jdraws):
        counts = np.bincount(d, minlength=6)
        chi2 = ((counts - n * p) ** 2 / (n * p)).sum()
        assert chi2 < 25.74  # chi-square, 5 degrees of freedom, p = 1e-4
    cfg = ModelConfig(**CFG_KW)
    tw = _port(jax_init(JaxConfig(**CFG_KW), seed=8, dtype=jnp.float32, scale=0.3), cfg)
    kw = dict(max_new_tokens=6, temperature=1.0, compute_dtype=torch.float32, device="cpu",
              stop_tokens=set())
    assert generate(tw, cfg, [1, 2, 3], seed=5, **kw) == generate(tw, cfg, [1, 2, 3], seed=5, **kw)


def test_perplexity_matches_jax(models):
    """Windows of 16 (burn-in 8), batches of 2, 5 whole windows and a
    remainder (the last batch padded): ppl and nll within relative 1e-5 of
    JAX's (f32), the same token and window counts; the Q4_K llama within
    relative 1e-3 (the bf16 rounding of the activations entering its
    quantized products, module docstring, moved its ppl 1.8e-4 relative
    from JAX's here)."""
    for name, rel in (("phi2", 1e-5), ("llama_q4k", 1e-3)):
        jcfg, jw, cfg, tw, _ = models[name]
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, 5 * 16 + 7).tolist()
        want = jax_perplexity(jw, jcfg, toks, window=16, batch_size=2, compute_dtype=jnp.float32)
        got = compute_perplexity(tw, cfg, toks, window=16, batch_size=2,
                                 compute_dtype=torch.float32, device="cpu")
        assert (got["tokens_scored"], got["windows"]) == (want["tokens_scored"],
                                                          want["windows"]) == (5 * 8, 5)
        for key in ("ppl", "nll"):
            assert got[key] == pytest.approx(want[key], rel=rel)


@pytest.mark.parametrize("pooling,normalize", [("last", True), ("mean", False), ("cls", True)])
def test_embed_matches_jax(models, pooling, normalize):
    """Three sequences of 5, 11 and 8 tokens padded to 11, through a bf16
    cache in bf16 compute as JAX runs them: the pooled states (normalised,
    or raw for ``mean``) within 2e-2 of the largest |value| (bf16
    activations; JAX's and the port's bf16 elementwise ops round at
    different points)."""
    jcfg, jw, cfg, tw, _ = models["phi2"]
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 11, 8)]
    want = np.asarray(jax_embed(jw, jcfg, seqs, pooling=pooling, normalize=normalize))
    got = embed(tw, cfg, seqs, pooling=pooling, normalize=normalize, device="cpu")
    assert got.dtype == np.float32 and got.shape == (3, cfg.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------


def _text(path, seed, lines, words):
    rng = np.random.default_rng(seed)
    path.write_text("\n".join(" ".join(f"w{i}" for i in rng.integers(0, 128, words))
                              for _ in range(lines)) + "\n\nw3\n")
    return path


def test_cli_imatrix_and_perplexity_match_jax(tmp_path, capsys):
    """On the tiny llama HF directory of ``tests/test_torch_isq.py``: the
    ``imatrix`` command's ``.npz`` against the JAX command's (every tap
    within rtol 1e-5) and its printed line equal (an empty line and a
    one-token line skipped); ``perplexity --dtype f32 --compare-isq q4k``:
    the same JSON lines (model, quant, windows, tokens), the f32 base's ppl
    and nll within relative 1e-5, the Q4_K line's within 1e-3 and its
    delta_ppl within 1e-3 of the ppl (as ``test_perplexity_matches_jax``:
    1.2e-4 relative apart here)."""
    model = tmp_path / "m"
    _write_dir(model, "llama_q4k_imatrix", seed=1, tokenizer=True)
    calib = _text(tmp_path / "calib.txt", 0, 2, 20)
    assert jax_cli.main(["imatrix", str(model), "--text", str(calib), "--chunk", "16",
                         "-o", str(tmp_path / "jax.npz")]) in (0, None)
    want_line = capsys.readouterr().out.strip().replace("jax.npz", "port.npz")
    assert cli.main(["imatrix", str(model), "--text", str(calib), "--chunk", "16",
                     "-o", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == want_line
    assert want_line.endswith("(32 calibration tokens)")
    want, got = load_imatrix(tmp_path / "jax.npz"), load_imatrix(tmp_path / "port.npz")
    assert sorted(got) == sorted(want) == ["attn_in", "down_in", "mlp_in", "o_in"]
    for tap in want:
        np.testing.assert_allclose(got[tap], want[tap], rtol=1e-5, atol=1e-9)
    text = _text(tmp_path / "eval.txt", 1, 4, 24)
    args = ["perplexity", str(model), str(text), "--window", "16", "--batch-size", "2",
            "--dtype", "f32", "--compare-isq", "q4k", "-q"]
    assert jax_cli.main(args) in (0, None)
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [g["quant"] for g in got] == [w["quant"] for w in want] == ["base", "q4k"]
    for g, w, rel in zip(got, want, (1e-5, 1e-3)):
        assert {k: g[k] for k in ("model", "windows", "tokens_scored")} == \
            {k: w[k] for k in ("model", "windows", "tokens_scored")}
        for key in ("ppl", "nll"):
            assert g[key] == pytest.approx(w[key], rel=rel)
    assert got[1]["delta_ppl"] == pytest.approx(want[1]["delta_ppl"], abs=1e-3 * want[1]["ppl"])


def test_plain_counts_on_the_contiguous_path(models):
    """On the CPU the Q4_K llama's projections run the plain W4/W8
    versions: every quantized product of a forward counts once (7 a layer
    unfused, the Q8_0 head once)."""
    jcfg, jw, cfg, tw, _ = models["llama_q4k"]
    reset_counts()
    forward(tw, cfg, torch.zeros((1, 4), dtype=torch.long), torch.arange(4)[None],
            KVCache.create(cfg, 1, 4, dtype=torch.float32, device="cpu"), [0],
            compute_dtype=torch.float32)
    assert COUNTS["w4_matmul_plain"] == 7 * cfg.num_layers
    assert COUNTS["w8_matmul_plain"] == 1
