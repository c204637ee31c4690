"""The quantized (int8, fp8-e4m3) paged decode and prefill with every option
of the bf16 forms: sliding windows, the attention logit softcap, attention
sinks and head_dim 64, 128 and 256, on the CPU.

* One small case per (kernel, option) against the JAX Pallas kernels with
  ``kv_scale`` in interpret mode: the plain decode within 1e-4 (f32
  queries; exp against exp2, sum order), the plain prefill within 1e-2
  (the JAX kernel rounds P to bf16); the written codes bit-equal to an
  independent numpy quantization and the scales to JAX's. The prefill's
  chunk rows are codes times a power of two (:func:`exact_rows`), whose
  quantization every division gives exactly: the JAX kernels in interpret
  mode do not always divide exactly (``test_torch_kv_quant.py``), and in
  a short chunk a code taken across a midpoint in an early row reaches
  most later rows. The JAX package
  reaches its kernels at head_dim 64 with rows padded to 128 lanes
  (``_lanes``): zeros change neither a row's absmax nor a product.
* Every (head_dim, code type) with the options alone and together, against
  JAX ``sdpa`` over K/V dequantized the JAX way (``gather_kv`` with the
  packed scale plane) from the pools the plain version wrote, and, in the
  prefill, the chunk's own rows as the JAX prefill kernel reads them,
  ``bf16(code x s)`` with the f32 scale (numpy): 1e-4 (f32, the same
  values summed in another order). Each option moves the output by more
  than 1e-2 (a control that it bites).
* Shared with the model tests: :func:`xla_chunk_reading` and
  :func:`engines_agree` (the engines' greedy tokens over 1-byte pools).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import gather_kv as jax_gather
from mistralrs_tpu.ops.attention import sdpa as jax_sdpa
from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

from test_torch_kv_quant import (
    QUANTS,
    bf16_valued,
    check_codes,
    check_scales,
    exact_quant,
    expected_pool,
    packed,
    quant_pools,
    to_jax_codes,
    u8,
)

BS, W, N_KV = 16, 4, 2
CAPS = {"int8": 127.0, "fp8": 448.0}


def _slot(bt, b, p):
    return int(bt[b, p // BS] * BS + p % BS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lanes(a):
    """``a`` zero-padded to 128 head dims (JAX's head_dim-64 pools)."""
    a = np.asarray(a)
    pad = 128 - a.shape[-1]
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]) if pad > 0 else a


def _jax_codes(t, kv_quant):
    return to_jax_codes(torch.from_numpy(_lanes(u8(t))).view(t.dtype), kv_quant)


def _name(kernel, kv_quant, hd):
    return f"{kernel}_{kv_quant}" + (f"_hd{hd}" if hd in (64, 256) else "")


def _options(option, hd, n_q, rng):
    """(window, softcap, sinks, q multiplier) of one option's case."""
    sinks = (rng.standard_normal(n_q) * 2 + 1).astype(np.float32)
    return {"window": (5, 0.0, None, 1.0), "softcap": (0, 8.0, None, 3.0),
            "sinks": (0, 0.0, sinks, 1.0), "hd64": (0, 0.0, None, 1.0),
            "hd256": (0, 0.0, None, 1.0), "all": (5, 8.0, sinks, 3.0),
            "none": (0, 0.0, None, 1.0)}[option]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_case(kv_quant, hd, group, seed):
    """3 rows: kv_len 37 (not a multiple of a block), kv_len 1 (a dropped
    write, slot -1), kv_len 64 (the whole table)."""
    b = 3
    rng = np.random.default_rng(seed)
    s_total = (b * W + 1) * BS
    pools = quant_pools(rng, N_KV, s_total, hd, kv_quant)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    kv_lens = np.array([37, 1, W * BS], np.int32)
    slots = np.array([_slot(bt, 0, 36), -1, _slot(bt, 2, W * BS - 1)], np.int32)
    q = rng.standard_normal((b, N_KV * group, hd)).astype(np.float32)
    kn = bf16_valued(rng, b, N_KV, hd)
    vn = bf16_valued(rng, b, N_KV, hd)
    return rng, pools, (q, kn, vn, slots, bt, kv_lens)


def run_decode(pools, q, kn, vn, slots, bt, kv_lens, window, softcap, sinks, scale):
    mine = [t.clone() for t in pools]
    out = paged_decode_attention_fused(
        _t(q), mine[0], mine[2], _t(kn), _t(vn), _t(slots), _t(bt), _t(kv_lens),
        block_size=BS, scale=scale, window=window, softcap=softcap,
        sinks=None if sinks is None else _t(sinks), k_scale=mine[1], v_scale=mine[3])
    return out, mine


DECODE_CASES = [("window", 128, "int8"), ("softcap", 128, "fp8"), ("sinks", 128, "int8"),
                ("hd64", 64, "fp8"), ("hd256", 256, "int8")]


@pytest.mark.parametrize("option,hd,kv_quant", DECODE_CASES)
def test_decode_option_matches_pallas(option, hd, kv_quant):
    group = 4
    rng, pools, (q, kn, vn, slots, bt, kv_lens) = decode_case(kv_quant, hd, group, hd + 1)
    window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
    q = q * mult
    scale = hd ** -0.5
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_decode(
        jnp.asarray(_lanes(q)), _jax_codes(k, kv_quant), _jax_codes(v, kv_quant),
        jnp.asarray(_lanes(kn)), jnp.asarray(_lanes(vn)), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(kv_lens), window, 0, packed(ks, vs),
        None if sinks is None else jnp.asarray(sinks), block_size=BS, scale=scale,
        softcap=softcap, interpret=True)
    reset_counts()
    to, mine = run_decode(pools, q, kn, vn, slots, bt, kv_lens, window, softcap, sinks, scale)
    assert COUNTS[_name("paged_decode", kv_quant, hd) + "_plain"] == 1
    assert sum(COUNTS.values()) == 1
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[..., :hd], atol=1e-4)
    for new, i, jc in ((kn, 0, jk), (vn, 2, jv)):
        ref, ys, sc = expected_pool(u8(pools[i]), pools[i + 1], new, slots, kv_quant)
        check_codes(u8(mine[i]), u8(jc)[..., :hd], ref, ys, kv_quant)
        np.testing.assert_array_equal(mine[i + 1].float().numpy()[:, :-1], sc[:, :-1])
    check_scales(mine[1], mine[3], jkvs)


def _dequantized(pools, bt, kv_quant):
    """K/V [B, W * BS, n_kv, hd] f32 dequantized the JAX way from the
    port's code pools and scale planes."""
    k, ks, v, vs = pools
    hd = k.shape[-1]
    jk, jv = jax_gather(_jax_codes(k, kv_quant), _jax_codes(v, kv_quant), jnp.asarray(bt), BS,
                        packed(ks, vs), dtype=jnp.float32)
    return np.array(jk)[..., :hd], np.array(jv)[..., :hd]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_decode_options_match_sdpa(kv_quant, hd):
    group = 2
    rng, pools, (q, kn, vn, slots, bt, kv_lens) = decode_case(kv_quant, hd, group, 7 * hd)
    for option in ("none", "window", "softcap", "sinks", "all"):
        window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
        reset_counts()
        to, mine = run_decode(pools, q * mult, kn, vn, slots, bt, kv_lens, window, softcap,
                              sinks, hd ** -0.5)
        assert COUNTS[_name("paged_decode", kv_quant, hd) + "_plain"] == 1
        without, _ = run_decode(pools, q * mult, kn, vn, slots, bt, kv_lens, 0, 0.0, None,
                                hd ** -0.5)
        kk, vv = _dequantized(mine, bt, kv_quant)
        js = jax_sdpa(jnp.asarray(q[:, None] * mult), jnp.asarray(kk), jnp.asarray(vv),
                      q_positions=jnp.asarray(kv_lens - 1)[:, None], kv_len=jnp.asarray(kv_lens),
                      scale=hd ** -0.5, logit_softcap=softcap or None,
                      sliding_window=window or None,
                      sinks=None if sinks is None else jnp.asarray(sinks))
        np.testing.assert_allclose(to.numpy(), np.asarray(js)[:, 0], atol=1e-4, err_msg=option)
        if option != "none":  # the option bites
            assert (to - without).abs().max() > 1e-2, option


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill_case(kv_quant, hd, group, seed):
    """2 rows of a 12-token chunk: 12 valid on a past of 20 (the chunk
    crosses the window's edge), 5 valid on a past of 3 (n_valid < T)."""
    b, t = 2, 12
    rng = np.random.default_rng(seed)
    s_total = (b * W + 1) * BS
    pools = quant_pools(rng, N_KV, s_total, hd, kv_quant)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    n_valid = np.array([12, 5], np.int32)
    kv_lens = n_valid + np.array([20, 3], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((b, t), -1, np.int32)
    for i in range(b):
        slots[i, :n_valid[i]] = [_slot(bt, i, ctx[i] + j) for j in range(n_valid[i])]
    q = rng.standard_normal((b, t, N_KV * group, hd)).astype(np.float32)
    kn = bf16_valued(rng, b, t, N_KV, hd)
    vn = bf16_valued(rng, b, t, N_KV, hd)
    return rng, pools, (q, kn, vn, slots, bt, kv_lens, n_valid)


def exact_rows(rng, kv_quant, *shape):
    """f32 rows of codes times 2^-7 (int8) or 2^-9 (e4m3), each with one
    code at the cap: the scale is exactly that power of two, and so is
    every quotient's divisor."""
    if kv_quant == "int8":
        codes = rng.integers(-127, 128, shape).astype(np.float32)
        unit = 2.0 ** -7
    else:
        raw = rng.integers(0, 256, shape).astype(np.uint8)
        raw[(raw & 0x7F) == 0x7F] = 0  # no NaN
        codes = raw.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
        unit = 2.0 ** -9
    cap = CAPS[kv_quant]
    codes[..., 0] = np.where(rng.integers(0, 2, shape[:-1]) == 1, cap, -cap)
    return (codes * np.float32(unit)).astype(np.float32)


def run_prefill(pools, q, kn, vn, slots, bt, kv_lens, n_valid, window, softcap, sinks, scale):
    mine = [t.clone() for t in pools]
    out = paged_prefill_attention_fused(
        _t(q), mine[0], mine[2], _t(kn), _t(vn), _t(slots), _t(bt), _t(kv_lens), _t(n_valid),
        block_size=BS, scale=scale, window=window, softcap=softcap,
        sinks=None if sinks is None else _t(sinks), k_scale=mine[1], v_scale=mine[3])
    return out, mine


PREFILL_CASES = [("window", 128, "fp8"), ("softcap", 128, "int8"), ("sinks", 128, "fp8"),
                 ("hd64", 64, "int8"), ("hd256", 256, "fp8")]


@pytest.mark.parametrize("option,hd,kv_quant", PREFILL_CASES)
def test_prefill_option_matches_pallas(option, hd, kv_quant):
    group = 2
    rng, pools, case = prefill_case(kv_quant, hd, group, 3 * hd + 1)
    q, kn, vn, slots, bt, kv_lens, n_valid = case
    kn, vn = (exact_rows(rng, kv_quant, *kn.shape) for _ in range(2))
    window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
    q = q * mult
    scale = hd ** -0.5
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_prefill(
        jnp.asarray(_lanes(q)), _jax_codes(k, kv_quant), _jax_codes(v, kv_quant),
        jnp.asarray(_lanes(kn)), jnp.asarray(_lanes(vn)), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(kv_lens), jnp.asarray(n_valid), window, 0, packed(ks, vs),
        None if sinks is None else jnp.asarray(sinks), block_size=BS, scale=scale,
        softcap=softcap, interpret=True)
    reset_counts()
    to, mine = run_prefill(pools, q, kn, vn, slots, bt, kv_lens, n_valid, window, softcap,
                           sinks, scale)
    assert COUNTS[_name("paged_prefill", kv_quant, hd) + "_plain"] == 1
    assert sum(COUNTS.values()) == 1
    b, t, n_kv, _ = kn.shape
    for new, i, jc in ((kn, 0, jk), (vn, 2, jv)):
        ref, ys, sc = expected_pool(u8(pools[i]), pools[i + 1], new.reshape(b * t, n_kv, hd),
                                    slots, kv_quant)
        assert len(check_codes(u8(mine[i]), u8(jc)[..., :hd], ref, ys, kv_quant)) == 0
        np.testing.assert_array_equal(mine[i + 1].float().numpy()[:, :-1], sc[:, :-1])
    check_scales(mine[1], mine[3], jkvs)
    valid = np.arange(t)[None] < n_valid[:, None]
    np.testing.assert_allclose(to.numpy()[valid], np.asarray(jo)[..., :hd][valid], atol=1e-2)


def _round_trip(rows, kv_quant):
    """The JAX prefill kernel's reading of a chunk's own rows: bf16(code x
    s) with the unrounded f32 scale (numpy)."""
    codes, _, _ = exact_quant(rows, kv_quant)
    x = np.asarray(rows, np.float32)
    s = (np.abs(x).max(-1) / np.float32(CAPS[kv_quant])).astype(np.float32)
    dt = np.int8 if kv_quant == "int8" else ml_dtypes.float8_e4m3fn
    vals = codes.view(dt).astype(np.float32) * s[..., None]
    return vals.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_prefill_options_match_sdpa(kv_quant, hd):
    group = 4
    rng, pools, case = prefill_case(kv_quant, hd, group, 11 * hd)
    q, kn, vn, slots, bt, kv_lens, n_valid = case
    ctx = kv_lens - n_valid
    t = q.shape[1]
    valid = np.arange(t)[None] < n_valid[:, None]
    for option in ("none", "window", "softcap", "sinks", "all"):
        window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
        reset_counts()
        to, mine = run_prefill(pools, q * mult, kn, vn, slots, bt, kv_lens, n_valid, window,
                               softcap, sinks, hd ** -0.5)
        assert COUNTS[_name("paged_prefill", kv_quant, hd) + "_plain"] == 1
        without, _ = run_prefill(pools, q * mult, kn, vn, slots, bt, kv_lens, n_valid, 0, 0.0,
                                 None, hd ** -0.5)
        kk, vv = _dequantized(mine, bt, kv_quant)
        for i in range(len(n_valid)):  # the chunk's own rows, as the kernel reads them
            c, n = int(ctx[i]), int(n_valid[i])
            kk[i, c:c + n] = _round_trip(kn[i, :n], kv_quant)
            vv[i, c:c + n] = _round_trip(vn[i, :n], kv_quant)
        js = jax_sdpa(jnp.asarray(q * mult), jnp.asarray(kk), jnp.asarray(vv),
                      q_positions=jnp.asarray(ctx[:, None] + np.arange(t)[None]),
                      kv_len=jnp.asarray(kv_lens), scale=hd ** -0.5,
                      logit_softcap=softcap or None, sliding_window=window or None,
                      sinks=None if sinks is None else jnp.asarray(sinks))
        got = to.numpy()
        np.testing.assert_allclose(got[valid], np.asarray(js)[valid], atol=1e-4, err_msg=option)
        if option != "none":  # the option bites
            assert np.abs(got - without.numpy())[valid].max() > 1e-2, option


# ---------------------------------------------------------------------------
# engines (shared with the model tests)
# ---------------------------------------------------------------------------


def xla_chunk_reading(monkeypatch):
    """The port's prefill reads its chunk's own rows as the JAX package's
    XLA path does, ``code x bf16(s)`` in f32 from the pool, in place of the
    JAX prefill kernel's ``bf16(code x s)``: the engines then compute the
    same function, and an fp8 run cannot part at a near-tie over that one
    rounding (held against the JAX kernel above)."""
    monkeypatch.setattr(pa, "chunk_round_trip", lambda codes, s: codes.to(torch.float32)
                        * s.to(torch.bfloat16).to(torch.float32)[..., None])


def engines_agree(jcfg, jw, cfg, tw, kv_quant, prompts, max_tokens=10, chunk=8):
    """Both engines (f32, ``kv_quant`` pools or bf16 ones, ``chunk``-token
    prefill chunks, blocks of 8) serve ``prompts`` greedily: identical
    tokens, every request to its end."""
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=chunk, kv_quant=kv_quant)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(cfg, tw, compute_dtype=torch.float32, device="cpu", **ekw)
    assert te.cache.quantized == (kv_quant is not None)
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=max_tokens)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
          for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == max_tokens for s in ts)
