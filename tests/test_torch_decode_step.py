"""The port's decode step (``engine/decode_step.py``, the counterpart of the
JAX engine's jitted ``_decode_fn``) and its on-device seeded sampler
(``engine/sampler.py``) against the JAX package, on the CPU, where the step
function runs uncaptured; and, marked ``cuda``, the captured graph on the
card.

* Greedy tokens: both engines (f32 compute and pools, where the packages
  agree to ~1e-6, so arg-maxes do not flip on rounding) serve requests that
  join over time and leave at different lengths (>= 8 decode steps), on a
  tiny llama, a tiny Mixtral (Q4_K gate/up, Q6_K down banks) and a tiny
  DeepSeek V2: the tokens are identical.
* Seeded draws do not depend on the slot or on the batch.
* Draw frequencies: 20000 draws of 16 tokens (20000 slots, seeds 0-19999,
  or one seed at draw counts 0-19999) against the JAX sampler's filtered
  softmax (``_transformed_probs``): Pearson's chi-square over the tokens
  the filter keeps (each expected >= 5 times), p >= 1e-3 with fixed seeds,
  and no draw of a filtered token. With penalties and logit bias (not in
  ``_transformed_probs``), 20000 draws against 20000 of the JAX ``sample``
  (one key, 20000 rows): the chi-square test of the 2 x V table, p >= 1e-3.
* Penalties, logit bias and top logprobs: greedy tokens equal to the JAX
  ``sample``'s, logprobs and top-logprob values within 1e-5, top ids equal.
* The kernels' split state: its sizing from the plans covers every launch
  of the wrappers at the engine's shapes (driven with a fake library on
  meta tensors), and a held buffer refuses to grow.

Card-side: ``python -m pytest tests/test_torch_decode_step.py -q -m cuda
--noconftest`` (the JAX side of this file then does not run: it imports
JAX lazily).
"""

import gc

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.engine.decode_step import DecodeStep
from mistralrs_tpu_torch.engine.engine import Engine, decode_widths, forward_rows
from mistralrs_tpu_torch.engine.sampler import (
    BatchSamplingState,
    SamplingParams,
    gumbel_noise,
    row_keys,
    sample,
)
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models import deepseek as tds
from mistralrs_tpu_torch.models import llama as tll
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.ops import mla_attention as ma
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.quant.qtensor import QTensor

V = 16
LOGITS = np.random.default_rng(3).standard_normal((1, V)).astype(np.float32) * 1.5
P_MIN = 1e-3  # chi-square p threshold (fixed seeds: the test is deterministic)


def _jax():
    import jax
    import jax.numpy as jnp

    from mistralrs_tpu.engine import sampler as js

    return jax, jnp, js


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engine, requests joining and leaving
# ---------------------------------------------------------------------------


def _engines(model):
    """(JAX engine, port engine) on one tiny model, f32 compute and pools
    (``..._int8``: int8 pools on both sides)."""
    _, jnp, _ = _jax()
    from mistralrs_tpu.engine.engine import Engine as JaxEngine

    kw = dict(num_blocks=40, block_size=16, max_batch=3)
    if model.endswith("_int8"):
        model, kw["kv_quant"] = model[:-len("_int8")], "int8"
    if model == "deepseek":
        from mistralrs_tpu.engine.adapters import DeepseekAdapter as JaxAdapter
        from mistralrs_tpu_torch.engine.adapters import DeepseekAdapter
        from test_torch_deepseek import V2, both

        jcfg, jw, cfg, tw = both(V2, seed=5)
        return (JaxEngine(jcfg, jw, adapter=JaxAdapter(jcfg, jw), backend="xla",
                          compute_dtype=jnp.float32, **kw),
                Engine(cfg, None, adapter=DeepseekAdapter(cfg, tw, compute_dtype=torch.float32,
                                                          device="cpu"), device="cpu", **kw))
    from mistralrs_tpu.engine.engine import Engine as JaxEngine
    from mistralrs_tpu_torch.convert import from_jax_params

    if model == "llama":
        from test_torch_engine import CFG, JCFG, JW, TW

        jcfg, jw, cfg, tw = JCFG, JW, CFG, TW
    else:
        from test_torch_moe import MIXED, MOE_KW, _jax_moe_weights, jax_to_numpy

        mkw = dict(MOE_KW, arch="mixtral")
        jcfg, jw = _jax_moe_weights(mkw, [MIXED, MIXED], seed=23)
        cfg = ModelConfig(**mkw)
        tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    return (JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **kw),
            Engine(cfg, tw, compute_dtype=torch.float32, device="cpu", **kw))


@pytest.mark.parametrize("model", ["llama", "mixtral", "deepseek", "deepseek_int8"])
def test_greedy_matches_jax_with_requests_joining_and_leaving(model):
    """3 slots, 5 requests of 9-12 tokens: two start, three more arrive
    after 3 steps, and each takes a slot another left; every request's
    greedy tokens equal the JAX engine's (DeepSeek's uncaptured decode step
    over an int8 latent pool too)."""
    _, _, js = _jax()
    je, te = _engines(model)
    rng = np.random.default_rng(17)
    prompts = [[int(x) for x in rng.integers(1, 120, 5 + 4 * i)] for i in range(5)]
    lengths = [9, 12, 10, 11, 9]
    js_seqs, ts_seqs, slots = [], [], {}

    def add(i):
        js_seqs.append(je.add_request(prompts[i], js.SamplingParams(temperature=0.0,
                                                                    max_tokens=lengths[i])))
        ts_seqs.append(te.add_request(prompts[i], SamplingParams(temperature=0.0,
                                                                 max_tokens=lengths[i])))

    add(0)
    add(1)
    for step in range(40):
        if step == 3:
            for i in (2, 3, 4):
                add(i)
        if not (je.has_work or te.has_work or step < 3):
            break
        je.step()
        te.step()
        for s in ts_seqs:
            if s.slot is not None and not s.is_finished:
                slots.setdefault(s.request_id, s.slot)
    assert not je.has_work and not te.has_work
    assert [s.generated_ids for s in ts_seqs] == [s.generated_ids for s in js_seqs]
    assert [len(s.generated_ids) for s in ts_seqs] == lengths
    assert len(slots) == 5 and len(set(slots.values())) == 3  # 5 requests through 3 slots


# ---------------------------------------------------------------------------
# seeded draws
# ---------------------------------------------------------------------------


def test_seeded_draws_independent_of_slot_and_batch():
    """A seeded request draws the same tokens alone in slot 0 as in slot 2
    beside two other sampled requests, and the sampler's draw for one
    (seed, draw count) is the same in any row of any batch."""
    from test_torch_engine import CFG, TW

    p = SamplingParams(temperature=1.1, top_k=60, top_p=0.95, seed=2024, max_tokens=10)
    te = Engine(CFG, TW, device="cpu", num_blocks=64, block_size=16, max_batch=4)
    a = te.add_request([5, 6, 7, 8], p)
    te.step()
    slot_a = a.slot
    te.run_to_completion()
    te.add_request([9] * 20, SamplingParams(temperature=1.0, seed=1, max_tokens=12))
    te.add_request([3] * 6, SamplingParams(temperature=0.7, seed=2, max_tokens=12))
    b = te.add_request([5, 6, 7, 8], p)
    te.step()
    slot_b = b.slot
    te.run_to_completion()
    assert (slot_a, slot_b) == (0, 2)
    assert a.output_ids == b.output_ids and len(a.output_ids) == 10

    state = BatchSamplingState.create(6, V, "cpu")
    sp = SamplingParams(temperature=0.9)
    for slot in range(6):
        state.admit(slot, sp, [], seed=(77 if slot in (1, 4) else slot), drawn=3)
    toks, _, _ = sample(torch.from_numpy(LOGITS).repeat(6, 1), state)
    one = BatchSamplingState.create(1, V, "cpu")
    one.admit(0, sp, [], seed=77, drawn=3)
    alone, _, _ = sample(torch.from_numpy(LOGITS), one)
    assert toks[1] == toks[4] == alone[0]
    assert state.drawn.tolist() == [4] * 6


def test_noise_hash_is_integer_exact():
    """The hash stays in 32 bits (no int64 product overflows) and its bits
    are pinned: the same (seed, draw count, token) gives these values on
    any device."""
    lo = torch.tensor([0, 0xFFFFFFFF, 12345], dtype=torch.long)
    hi = torch.tensor([0, 0xFFFFFFFF, 0], dtype=torch.long)
    drawn = torch.tensor([0, 2**40 + 7, 1], dtype=torch.long)
    keys = row_keys(lo, hi, drawn)
    assert keys.min() >= 0 and keys.max() < 2**32
    state = BatchSamplingState.create(1, V, "cpu")
    assert state.tok_hash.min() >= 0 and state.tok_hash.max() < 2**32
    g = gumbel_noise(keys, state.tok_hash)
    assert g.dtype == torch.float64 and torch.isfinite(g).all()
    assert g.shape == (3, V) and len(set(g.flatten().tolist())) == 3 * V
    # pinned bits: a change to the hash changes every request's draws
    assert keys.tolist() == row_keys(lo, hi, drawn).tolist()
    assert keys.tolist() == [int(k) for k in keys]  # python ints, no wrap


def _draws(params: SamplingParams, n: int, counts_seed=None, context=()):
    """n draws from n slots of one batch: seeds 0..n-1 at draw count 0, or
    one seed ``counts_seed`` at draw counts 0..n-1."""
    state = BatchSamplingState.create(n, V, "cpu")
    for slot in range(n):
        if counts_seed is None:
            state.admit(slot, params, list(context), seed=slot)
        else:
            state.admit(slot, params, list(context), seed=counts_seed, drawn=slot)
    toks, _, _ = sample(torch.from_numpy(LOGITS).repeat(n, 1), state)
    return np.bincount(toks.numpy(), minlength=V)


FILTERS = {
    "temperature": dict(temperature=1.3),
    "top_k": dict(temperature=0.7, top_k=5),
    "top_p": dict(temperature=1.2, top_p=0.8),
    "min_p": dict(temperature=1.0, min_p=0.1),
    "all": dict(temperature=0.9, top_k=8, top_p=0.9, min_p=0.02),
}


@pytest.mark.parametrize("over", ["seeds", "draw_counts"])
@pytest.mark.parametrize("name", list(FILTERS))
def test_draw_frequencies_match_jax_filtered_softmax(name, over):
    from scipy import stats

    jax, jnp, js = _jax()
    kw = FILTERS[name]
    n = 20000
    obs = _draws(SamplingParams(**kw), n, counts_seed=None if over == "seeds" else 99)
    jstate = js.make_batch_state([js.SamplingParams(**kw)], V, [[]])
    probs = np.asarray(js._transformed_probs(jnp.asarray(LOGITS), jstate), np.float64)[0]
    kept = probs > 0
    assert obs[~kept].sum() == 0  # a filtered token is never drawn
    exp = probs[kept] / probs[kept].sum() * n
    assert exp.min() >= 5
    if kept.sum() > 1:
        p = stats.chisquare(obs[kept], exp).pvalue
        assert p >= P_MIN, (name, over, p, obs, exp)


def test_penalized_draws_match_jax_sample():
    """Penalties and logit bias shape the distribution the same way:
    20000 port draws against 20000 JAX ``sample`` draws (rows of one batch)
    of the same request, the 2 x V table's chi-square p >= 1e-3."""
    from scipy import stats

    jax, jnp, js = _jax()
    kw = dict(temperature=0.8, top_p=0.97, frequency_penalty=0.3, presence_penalty=0.2,
              repetition_penalty=1.3, logit_bias={2: 1.5, 5: -2.0})
    ctx = [0, 1, 1, 4, 4, 4, 9]
    n = 20000
    obs = _draws(SamplingParams(**kw), n, context=ctx)
    jstate = js.make_batch_state([js.SamplingParams(**kw)] * n, V, [ctx] * n)
    jtok, _, _, _ = js.sample(jnp.asarray(np.repeat(LOGITS, n, 0)), jstate, jax.random.PRNGKey(5))
    jobs = np.bincount(np.asarray(jtok), minlength=V)
    cols = (obs + jobs) > 0
    p = stats.chi2_contingency(np.stack([obs[cols], jobs[cols]])).pvalue
    assert p >= P_MIN, (p, obs, jobs)


def test_penalties_bias_and_top_logprobs_match_jax():
    """Greedy rows with every penalty and a logit bias, over two steps (the
    second sees the first's token in its counts): tokens and top ids equal
    to the JAX ``sample``'s, logprobs and top values within 1e-5."""
    jax, jnp, js = _jax()
    rng = np.random.default_rng(11)
    b, v = 4, 64
    params = [dict(temperature=0.0), dict(temperature=0.0, repetition_penalty=1.4),
              dict(temperature=0.0, frequency_penalty=0.7, presence_penalty=0.5,
                   logit_bias={3: 2.0, 7: -1.0}),
              dict(temperature=0.0, top_k=v + 10, repetition_penalty=0.8, logit_bias={1: 9.0})]
    ctx = [[int(x) for x in rng.integers(0, v, 12)] for _ in range(b)]
    jstate = js.make_batch_state([js.SamplingParams(**p) for p in params], v, ctx)
    state = BatchSamplingState.create(b, v, "cpu")
    for slot, (p, c) in enumerate(zip(params, ctx)):
        state.admit(slot, SamplingParams(**p), c, seed=slot)
    for step in range(2):
        logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
        jt, jl, (jv, ji), jstate = js.sample(jnp.asarray(logits), jstate,
                                             jax.random.PRNGKey(step))
        tt, tl, (tv, ti) = sample(torch.from_numpy(logits), state)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(state.counts.numpy(), np.asarray(jstate.counts))


def test_empty_rows_keep_their_state():
    """Rows outside ``update`` (the decode step's empty slots) draw, but
    leave their counts and draw counts as they were."""
    state = BatchSamplingState.create(3, V, "cpu")
    for slot in range(3):
        state.admit(slot, SamplingParams(temperature=1.0), [1, 2], seed=slot, drawn=5)
    before = state.counts.clone()
    sample(torch.from_numpy(LOGITS).repeat(3, 1), state,
           update=torch.tensor([True, False, True]))
    assert state.drawn.tolist() == [6, 5, 6]
    assert torch.equal(state.counts[1], before[1])
    assert state.counts[0].sum() == before[0].sum() + 1


# ---------------------------------------------------------------------------
# the step function on the CPU
# ---------------------------------------------------------------------------


def test_cpu_step_runs_uncaptured_and_stages_empty_rows():
    """On the CPU the engine's step is the step function itself (no graph);
    the staging starts from empty rows (slot -1, kv_len 0)."""
    from test_torch_engine import CFG, TW

    te = Engine(CFG, TW, device="cpu", num_blocks=32, block_size=16, max_batch=2)
    ds = te.decode_step
    assert isinstance(ds, DecodeStep) and not ds.cuda
    stage = ds.staging(32)
    assert stage.shape == (2, 36) and stage.dtype == np.int32
    assert (stage[:, 2] == -1).all() and (stage[:, 3] == 0).all()
    s = te.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4))
    te.run_to_completion()
    assert len(s.output_ids) == 4 and not ds._graphs


# ---------------------------------------------------------------------------
# the kernels' split state
# ---------------------------------------------------------------------------


class _FakeLibrary:
    def __getattr__(self, name):
        return lambda *args: 0


def _recorded_split_state(monkeypatch, calls):
    """Drive the kernel wrappers on meta tensors through ``calls`` (a fake
    library, 132 SMs) and return the largest workspace and counters any
    launch asked for."""
    seen = {"floats": 0, "counters": 0}

    def ws(dev, n):
        seen["floats"] = max(seen["floats"], n)
        return torch.empty(n, dtype=torch.float32, device=dev)

    def cnt(dev, n):
        seen["counters"] = max(seen["counters"], n)
        return torch.empty(n, dtype=torch.int32, device=dev)

    for mod in (qm, pa, ma):
        monkeypatch.setattr(mod, "library", lambda: _FakeLibrary())
        monkeypatch.setattr(mod, "sm_count", lambda dev: 132)
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
        monkeypatch.setattr(mod, "split_counters", cnt)
    monkeypatch.setattr(qm, "split_workspace", ws)
    for call in calls:
        call()
    return seen["floats"], seen["counters"]


def _meta_qt(n, k, packed, gs=32):
    m = dict(device="meta")
    if packed:
        return QTensor(torch.empty((k // 2, n), dtype=torch.uint8, **m),
                       torch.empty((k // 32, n), **m), torch.empty((k // 32, n), **m),
                       group_size=32, packed=True, code_bits=4)
    return QTensor(torch.empty((k, n), dtype=torch.int8, **m), torch.empty((k // gs, n), **m),
                   None, group_size=gs, packed=False, code_bits=8)


def _matmul_call(qt, m):
    out = torch.empty((m, qt.out_features), dtype=torch.bfloat16, device="meta")
    x = torch.empty((m, qt.in_features), dtype=torch.bfloat16, device="meta")
    fmt = qm._plane_format(qt)
    if qt.packed:
        return lambda: qm._w4_launch(x, qt, out, True)
    return lambda: qm._w8_launch(x, qt, fmt, out, True)


def test_kernel_workspace_covers_every_launch(monkeypatch):
    """Llama-3-8B's projections (Q4_K, a Q8_0 head) and a Mixtral Q8_0
    ``attn_v`` (its W8 prefill body splits K) at every row count an engine
    of 8 slots, prefill chunks of 256 and 4 prompts a step runs, and the
    paged decode kernel at every width of a 1024-token table of 16-token
    blocks: ``kernel_workspace`` is the largest state any launch takes."""
    cfg = ModelConfig(arch="llama", vocab_size=128256, hidden_size=4096,
                      intermediate_size=14336, num_layers=1, num_heads=32, num_kv_heads=8,
                      head_dim=128, max_position_embeddings=1024)
    weights = {"layers": [{"wqkv": _meta_qt(6144, 4096, True), "wo": _meta_qt(4096, 4096, True),
                           "wgateup": _meta_qt(28672, 4096, True),
                           "down": _meta_qt(4096, 14336, True),
                           "attn_v": _meta_qt(1024, 4096, False)}],
               "lm_head": _meta_qt(128256, 4096, False)}
    rows, widths = forward_rows(8, 256, 4), decode_widths(1024, 16)
    assert rows == [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    assert widths == [32, 64]
    want = tll.kernel_workspace(weights, cfg, 8, rows, widths, 16, 132)
    bf = dict(dtype=torch.bfloat16, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")

    def decode(w):
        s_total = 8 * w * 16 + 16
        return lambda: pa._decode_cuda(
            torch.empty((8, 32, 128), **bf), torch.empty((8, s_total, 128), **bf),
            torch.empty((8, s_total, 128), **bf), torch.empty((8, 8, 128), **bf),
            torch.empty((8, 8, 128), **bf), torch.empty(8, **i32),
            torch.empty((8, w), **i32), torch.empty(8, **i32), 16, 0.1)

    mats = [qt for lw in weights["layers"] for qt in lw.values()] + [weights["lm_head"]]
    calls = [_matmul_call(qt, m) for qt in mats for m in rows] + [decode(w) for w in widths]
    got = _recorded_split_state(monkeypatch, calls)
    assert got == want and want[0] > 0 and want[1] > 0


def test_mla_workspace_covers_every_launch(monkeypatch):
    """DeepSeek-V2-Lite's MLA decode (16 heads, rank 512, rows of 576) over
    2 slots at every width of tables of 64-token blocks up to 8192 tokens
    (4 clusters of 16 splits at the widest): ``kernel_workspace``'s
    counters are the largest any launch takes."""
    cfg = tds.DeepseekConfig(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        moe_intermediate_size=1408, num_layers=1, num_heads=16, q_lora_rank=None,
        kv_lora_rank=512, qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
        n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
        first_k_dense_replace=1, max_position_embeddings=8192)
    widths = [32, 64, 128]
    b = 2
    want = tds.kernel_workspace({}, cfg, b, [b], widths, 64, 132)
    bf = dict(dtype=torch.bfloat16, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")

    def mla(w):
        s_total = b * w * 64 + 64
        return lambda: ma._mla_cuda(
            torch.empty((b, 16, 576), **bf), torch.empty((s_total, 576), **bf),
            torch.empty((b, 576), **bf), torch.empty(b, **i32), torch.empty((b, w), **i32),
            torch.empty(b, **i32), 64, 512, 0.1)

    got = _recorded_split_state(monkeypatch, [mla(w) for w in widths])
    assert got == want == (0, b * 16)
    assert ma.mla_plan(b, 1, 128, 64) == (64, 16)


def test_held_buffers_refuse_to_grow():
    """While a graph holds the split buffers, a request within the
    reservation gets the same tensor and a larger one raises; released,
    the buffers grow again."""
    dev = torch.device("cpu")
    _cuda.reserve(dev, 3 << 20, 4096)
    ws, cnt = _cuda.split_workspace(dev, 1), _cuda.split_counters(dev, 1)
    _cuda.hold_buffers(dev)
    try:
        assert _cuda.split_workspace(dev, 3 << 20) is ws
        assert _cuda.split_counters(dev, 4096) is cnt
        with pytest.raises(RuntimeError, match="reserve"):
            _cuda.split_workspace(dev, (3 << 20) + 1)
        with pytest.raises(RuntimeError, match="reserve"):
            _cuda.split_counters(dev, 4097)
    finally:
        _cuda.release_buffers(dev)
    assert _cuda.split_counters(dev, 4097).numel() >= 4097


def test_recording_launches_counts_once_per_replay():
    """Launch counts reported inside a recording (a capture) leave
    ``COUNTS`` as it was, and each replay adds them once."""
    _cuda.reset_counts()
    _cuda.COUNTS["w4_matmul"] += 2
    with _cuda.recording_launches() as rec:
        _cuda.COUNTS["w4_matmul"] += 3
        _cuda.COUNTS["paged_decode"] += 1
    assert rec == {"w4_matmul": 3, "paged_decode": 1}
    assert dict(_cuda.COUNTS) == {"w4_matmul": 2}
    _cuda.add_launches(rec)
    _cuda.add_launches(rec)
    assert dict(_cuda.COUNTS) == {"w4_matmul": 8, "paged_decode": 2}
    _cuda.reset_counts()


# ---------------------------------------------------------------------------
# on the card: capture, replay and the reservation rule
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_engine(dev, max_batch=4):
    """A 2-layer llama whose shapes the kernels take (head_dim 128, K and N
    multiples of 128), Q4_K-style projections and a Q8_0-style head, drawn
    on the card."""
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                      max_position_embeddings=1024)
    g = torch.Generator(device=dev).manual_seed(0)

    def q4(n, k):
        scale = torch.rand((k // 32, n), generator=g, device=dev) * 0.01
        return QTensor(torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                                     dtype=torch.uint8), scale, -8 * scale, group_size=32,
                       packed=True, code_bits=4)

    def q8(n, k):
        return QTensor(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                     dtype=torch.int8),
                       torch.rand((k // 32, n), generator=g, device=dev) * 0.002, None,
                       group_size=32, packed=False, code_bits=8)

    ones = torch.ones(256, dtype=torch.bfloat16, device=dev)
    layers = [{"attn_norm": ones, "ffn_norm": ones, "wqkv": q4(1024, 256), "wo": q4(256, 512),
               "wgateup": q4(1024, 256), "down": q4(256, 512)} for _ in range(2)]
    weights = {"embed": torch.randn((512, 256), generator=g, device=dev).to(torch.bfloat16),
               "layers": layers, "final_norm": ones, "lm_head": q8(512, 256)}
    return Engine(cfg, weights, num_blocks=64, block_size=64, max_batch=max_batch,
                  max_model_len=1024, device=dev)


@pytest.mark.cuda
def test_graph_replays_match_the_eager_step(dev):
    """From one saved state, 8 steps through the graph and 8 through the
    step function give bit-equal logits and the same greedy and seeded
    tokens; the replays count the kernels' launches and no plain version."""
    te = _card_engine(dev)
    seqs = [te.add_request([(5 * i + j) % 500 + 1 for j in range(20 + 7 * i)],
                           SamplingParams(temperature=0.0 if i % 2 else 0.8, seed=i,
                                          max_tokens=64)) for i in range(3)]
    while any(len(s.output_ids) < 2 for s in seqs):
        te.step()
    ds, width = te.decode_step, te._max_blocks_bucket()
    assert width in ds._graphs
    saved = (te.cache.k.clone(), te.cache.v.clone(),
             {k: getattr(te.samp_state, k).clone() for k in te.samp_state._ROWS})
    runs = []
    for mode in ("eager", "graph", "eager"):
        te.cache.k.copy_(saved[0])
        te.cache.v.copy_(saved[1])
        for k, t in saved[2].items():
            getattr(te.samp_state, k).copy_(t)
        toks = {s.slot: s.all_ids[-1] for s in seqs}
        logits, tokens = [], []
        _cuda.reset_counts()
        for i in range(8):
            stage = ds.staging(width)
            for s in seqs:
                pos = s.total_len - 1 + i
                table = te.kv.block_table(s.request_id)
                assert pos < 64 * len(table)  # within the blocks the sequence holds
                stage[s.slot, :4] = (toks[s.slot], pos, table[pos // 64] * 64 + pos % 64,
                                     pos + 1)
                stage[s.slot, 4:4 + len(table)] = table
            if mode == "eager":
                ds.upload(width)
                out = ds.compute(width)
            else:
                ds.launch(width)
                out = ds.graph_output(width)
            torch.cuda.synchronize()
            logits.append(out.logits.clone())
            tokens.append(out.tokens.tolist())
            toks = {s.slot: tokens[-1][s.slot] for s in seqs}
        runs.append((logits, tokens, dict(_cuda.COUNTS)))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert runs[0][1] == runs[1][1] == runs[2][1]
    counts = runs[1][2]
    assert counts["w4_matmul"] == 8 * 8 and counts["w8_matmul"] == 8
    assert counts["paged_decode"] == 8 * 2
    assert not any(k.endswith("_plain") for k in counts)
    ds.close()


@pytest.mark.cuda
def test_growth_raises_while_a_graph_lives(dev):
    """Once the engine's first graph is captured, the split buffers refuse
    to grow; a replay under the sync-debug mode makes no host sync; closed,
    the step lets them grow again."""
    gc.collect()  # engines of earlier tests release their graphs' hold
    te = _card_engine(dev)
    s = te.add_request(list(range(1, 30)), SamplingParams(temperature=0.0, max_tokens=4))
    te.run_to_completion()
    assert len(s.output_ids) == 4 and te.decode_step._graphs
    dev = te.device  # the device the engine's graphs hold the buffers of (cuda:0)
    ws = _cuda.split_workspace(dev, 1)
    with pytest.raises(RuntimeError, match="reserve"):
        _cuda.split_workspace(dev, ws.numel() + 1)
    width = next(iter(te.decode_step._graphs))
    te.decode_step.staging(width)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        te.decode_step.launch(width)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    te.decode_step.wait()
    te.decode_step.close()
    assert _cuda.split_workspace(dev, ws.numel() + 1).numel() > ws.numel()
