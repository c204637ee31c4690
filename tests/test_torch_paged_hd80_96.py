"""The paged decode and prefill at head_dims 80 and 96 (Phi-2, Phi-3-mini)
on the CPU: the plain versions of the kernels' head_dim-80 and -96 forms,
with unquantized (f32 here), int8 and fp8-e4m3 pools, sliding windows,
softcaps and sinks, held against the JAX package.

* Exactly one small case per (kernel, head dim) against the JAX fused
  kernels in interpret mode, every option on: the JAX package reaches its
  kernels at these head dims with pools and q/k/v zero-padded to 128 lanes
  (``auto_head_dim_pad``) and the scale of the true head dim, so the test
  pads them (zeros change neither a row's absmax nor a product) and
  compares the first 80 or 96 channels: decode within 1e-4 (f32 queries;
  exp against exp2, sum order), prefill within 1e-2 (the JAX kernel rounds
  P to bf16); codes bit-equal to an independent numpy quantization, scales
  to JAX's. The step's own rows are codes times a power of two
  (``test_torch_kv_quant_options.exact_rows``): the JAX kernels in
  interpret mode do not always divide exactly, and a code of the written
  row one off the exact one moves that row's output by up to 2e-2.
* The rest against JAX ``gather_kv`` + ``sdpa`` (1e-4, f32): every (head
  dim, pool type) with no option, each option alone and all together; each
  option moves the output by more than 1e-2 (a control that it bites).
* The decode kernel's plan and split state at D = 80 and 96: the wrapper
  driven with a fake kernel library on ``meta`` tensors passes the head dim,
  ``decode_plan``'s split and a partials buffer of ``hd + 2`` floats a
  (sequence, query head, split); the kernel's split arithmetic
  (``test_torch_attn_plan._emulate``) against JAX's decode kernel in
  interpret mode (padded, 1e-2 on bf16) and the plain version (1e-5, f32).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.ops.attention import sdpa as jax_sdpa
from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts

from test_torch_attn_plan import _emulate, _plain_f32
from test_torch_kv_quant import check_codes, check_scales, expected_pool, packed, u8
from test_torch_kv_quant_options import (
    BS,
    N_KV,
    _dequantized,
    _jax_codes,
    _lanes,
    _options,
    _round_trip,
    decode_case,
    exact_rows,
    prefill_case,
)
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

POOLS = [None, "int8", "fp8"]


def _name(kernel, kv_quant, hd):
    return f"{kernel}{'_' + kv_quant if kv_quant else ''}_hd{hd}"


def _f32_pools(pools, seed):
    """Unquantized pools of the quantized case's shape: [k, None, v, None]."""
    rng = np.random.default_rng(seed)
    shape = pools[0].shape
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), None,
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), None]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _copy(pools):
    return [None if t is None else t.clone() for t in pools]


def run_decode(pools, q, kn, vn, slots, bt, kv_lens, window, softcap, sinks, scale):
    mine = _copy(pools)
    out = paged_decode_attention_fused(
        _t(q), mine[0], mine[2], _t(kn), _t(vn), _t(slots), _t(bt), _t(kv_lens),
        block_size=BS, scale=scale, window=window, softcap=softcap,
        sinks=None if sinks is None else _t(sinks), k_scale=mine[1], v_scale=mine[3])
    return out, mine


def run_prefill(pools, q, kn, vn, slots, bt, kv_lens, n_valid, window, softcap, sinks, scale):
    mine = _copy(pools)
    out = paged_prefill_attention_fused(
        _t(q), mine[0], mine[2], _t(kn), _t(vn), _t(slots), _t(bt), _t(kv_lens), _t(n_valid),
        block_size=BS, scale=scale, window=window, softcap=softcap,
        sinks=None if sinks is None else _t(sinks), k_scale=mine[1], v_scale=mine[3])
    return out, mine


def _gathered(pools, bt):
    """K/V [B, W * BS, n_kv, hd] f32 through the block table (unquantized)."""
    idx = (bt[:, :, None] * BS + np.arange(BS)).reshape(bt.shape[0], -1)
    return [pools[i].numpy()[:, idx].transpose(1, 2, 0, 3) for i in (0, 2)]


# ---------------------------------------------------------------------------
# against the JAX kernels in interpret mode: one case per (kernel, head dim)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,kv_quant", [(80, "int8"), (96, "fp8")])
def test_decode_matches_pallas_padded(hd, kv_quant):
    group = 4
    rng, pools, (q, kn, vn, slots, bt, kv_lens) = decode_case(kv_quant, hd, group, hd)
    kn, vn = (exact_rows(rng, kv_quant, *kn.shape) for _ in range(2))
    window, softcap, sinks, mult = _options("all", hd, N_KV * group, rng)
    q = q * mult
    scale = hd ** -0.5  # the true head dim's, as JAX forward_paged passes it
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_decode(
        jnp.asarray(_lanes(q)), _jax_codes(k, kv_quant), _jax_codes(v, kv_quant),
        jnp.asarray(_lanes(kn)), jnp.asarray(_lanes(vn)), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(kv_lens), window, 0, packed(ks, vs), jnp.asarray(sinks), block_size=BS,
        scale=scale, softcap=softcap, interpret=True)
    reset_counts()
    to, mine = run_decode(pools, q, kn, vn, slots, bt, kv_lens, window, softcap, sinks, scale)
    assert COUNTS[_name("paged_decode", kv_quant, hd) + "_plain"] == 1
    assert sum(COUNTS.values()) == 1
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[..., :hd], atol=1e-4)
    assert not np.asarray(jo)[..., hd:].any()  # the padded lanes stay zero
    for new, i, jc in ((kn, 0, jk), (vn, 2, jv)):
        ref, ys, sc = expected_pool(u8(pools[i]), pools[i + 1], new, slots, kv_quant)
        check_codes(u8(mine[i]), u8(jc)[..., :hd], ref, ys, kv_quant)
        np.testing.assert_array_equal(mine[i + 1].float().numpy()[:, :-1], sc[:, :-1])
    check_scales(mine[1], mine[3], jkvs)


@pytest.mark.parametrize("hd,kv_quant", [(80, "fp8"), (96, "int8")])
def test_prefill_matches_pallas_padded(hd, kv_quant):
    group = 2
    rng, pools, case = prefill_case(kv_quant, hd, group, 3 * hd)
    q, kn, vn, slots, bt, kv_lens, n_valid = case
    kn, vn = (exact_rows(rng, kv_quant, *kn.shape) for _ in range(2))
    window, softcap, sinks, mult = _options("all", hd, N_KV * group, rng)
    q = q * mult
    scale = hd ** -0.5
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_prefill(
        jnp.asarray(_lanes(q)), _jax_codes(k, kv_quant), _jax_codes(v, kv_quant),
        jnp.asarray(_lanes(kn)), jnp.asarray(_lanes(vn)), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(kv_lens), jnp.asarray(n_valid), window, 0, packed(ks, vs),
        jnp.asarray(sinks), block_size=BS, scale=scale, softcap=softcap, interpret=True)
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


# ---------------------------------------------------------------------------
# against JAX gather_kv + sdpa
# ---------------------------------------------------------------------------

OPTIONS = ("none", "window", "softcap", "sinks", "all")


@pytest.mark.parametrize("kv_quant", POOLS)
@pytest.mark.parametrize("hd", [80, 96])
def test_decode_options_match_sdpa(hd, kv_quant):
    group = 2
    rng, pools, (q, kn, vn, slots, bt, kv_lens) = decode_case(kv_quant or "int8", hd, group,
                                                              7 * hd)
    if kv_quant is None:
        pools = _f32_pools(pools, hd)
    for option in OPTIONS:
        window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
        reset_counts()
        to, mine = run_decode(pools, q * mult, kn, vn, slots, bt, kv_lens, window, softcap,
                              sinks, hd ** -0.5)
        assert COUNTS[_name("paged_decode", kv_quant, hd) + "_plain"] == 1
        without, _ = run_decode(pools, q * mult, kn, vn, slots, bt, kv_lens, 0, 0.0, None,
                                hd ** -0.5)
        kk, vv = (_gathered(mine, bt) if kv_quant is None
                  else _dequantized(mine, bt, kv_quant))
        js = jax_sdpa(jnp.asarray(q[:, None] * mult), jnp.asarray(kk), jnp.asarray(vv),
                      q_positions=jnp.asarray(kv_lens - 1)[:, None], kv_len=jnp.asarray(kv_lens),
                      scale=hd ** -0.5, logit_softcap=softcap or None,
                      sliding_window=window or None,
                      sinks=None if sinks is None else jnp.asarray(sinks))
        np.testing.assert_allclose(to.numpy(), np.asarray(js)[:, 0], atol=1e-4, err_msg=option)
        if option != "none":  # the option bites
            assert (to - without).abs().max() > 1e-2, option


@pytest.mark.parametrize("kv_quant", POOLS)
@pytest.mark.parametrize("hd", [80, 96])
def test_prefill_options_match_sdpa(hd, kv_quant):
    group = 4
    rng, pools, case = prefill_case(kv_quant or "int8", hd, group, 11 * hd)
    q, kn, vn, slots, bt, kv_lens, n_valid = case
    if kv_quant is None:
        pools = _f32_pools(pools, hd + 1)
    ctx = kv_lens - n_valid
    t = q.shape[1]
    valid = np.arange(t)[None] < n_valid[:, None]
    for option in OPTIONS:
        window, softcap, sinks, mult = _options(option, hd, N_KV * group, rng)
        reset_counts()
        to, mine = run_prefill(pools, q * mult, kn, vn, slots, bt, kv_lens, n_valid, window,
                               softcap, sinks, hd ** -0.5)
        assert COUNTS[_name("paged_prefill", kv_quant, hd) + "_plain"] == 1
        without, _ = run_prefill(pools, q * mult, kn, vn, slots, bt, kv_lens, n_valid, 0, 0.0,
                                 None, hd ** -0.5)
        if kv_quant is None:
            kk, vv = _gathered(mine, bt)
        else:
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
# the decode kernel's plan and split state at D = 80 and 96
# ---------------------------------------------------------------------------


class _FakeLibrary:
    """Records the decode kernel's launch arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def mrt_paged_decode(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("hd", [80, 96])
def test_decode_plan_and_split_state(monkeypatch, hd):
    """Phi-3-mini's and Phi-2's 32/32 heads (group 1), B = 8 on tables of 16
    blocks of 64, on meta tensors: the kernel gets head_dim ``hd``, the
    plan's split and partials of B * n_q * splits * (hd + 2) floats."""
    fake = _FakeLibrary()
    empties = []
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        empties.append(out)
        return out

    monkeypatch.setattr(pa, "library", lambda: fake)
    monkeypatch.setattr(pa, "sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(pa, "split_counters",
                        lambda dev, n: real_empty(n, dtype=torch.int32, device=dev))
    monkeypatch.setattr(pa.torch, "empty", recording_empty)
    b, n_kv, n_q, w, bs = 8, 32, 32, 16, 64
    bf, i32 = dict(dtype=torch.bfloat16, device="meta"), dict(dtype=torch.int32, device="meta")
    s_total = (b * w + 1) * bs
    pa._decode_cuda(torch.zeros((b, n_q, hd), **bf), torch.zeros((n_kv, s_total, hd), **bf),
                    torch.zeros((n_kv, s_total, hd), **bf), torch.zeros((b, n_kv, hd), **bf),
                    torch.zeros((b, n_kv, hd), **bf), torch.zeros(b, **i32),
                    torch.zeros((b, w), **i32), torch.zeros(b, **i32), bs, hd ** -0.5)
    (args,) = fake.calls
    plan = pa.decode_plan(b, n_kv, 1, w, bs, 132)
    assert args[15] == hd and args[-4:-2] == tuple(plan)  # then e_mul and the stream
    parts = [e for e in empties if e.dtype == torch.float32]
    if plan.splits > 1:
        assert [p.numel() for p in parts] == [b * n_q * plan.splits * (hd + 2)]
    assert pa.decode_counters(plan, b, n_kv) == (b * n_kv if plan.splits > 1 else 0)


@pytest.mark.parametrize("hd", [80, 96])
def test_split_arithmetic_matches_jax_and_plain(hd):
    """The kernel's split arithmetic at 2 splits of 256 positions (group 2,
    blocks of 64: the JAX kernel in interpret mode walks each block in
    Python, 15 s a call at blocks of 16): kv_len 0 (dropped write), 100,
    256 (a split's end) and 500 (dropped)."""
    n_kv, group, bs, w, b = 2, 2, 64, 8, 4
    n_q = n_kv * group
    plan = pa.decode_plan(b, n_kv, group, w, bs, sms=16)
    assert plan == (256, 2)
    rng = np.random.default_rng(hd)
    s_total = (b * w + 1) * bs
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    kv_lens = np.array([0, 100, 256, 500], np.int32)
    slots = np.array([-1, bt[1, 99 // bs] * bs + 99 % bs, bt[2, 255 // bs] * bs + 255 % bs, -1],
                     np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kp, vp = f32(b, n_q, hd), f32(n_kv, s_total, hd), f32(n_kv, s_total, hd)
    kn, vn = f32(b, n_kv, hd), f32(b, n_kv, hd)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jb = lambda a: jnp.asarray(_lanes(a), jnp.bfloat16)  # noqa: E731
    scale = 1.0 / math.sqrt(hd)
    jo, _, _ = jax_decode(jb(q), jb(kp), jb(vp), jb(kn), jb(vn), jnp.asarray(slots),
                          jnp.asarray(bt), jnp.asarray(kv_lens), block_size=bs, scale=scale,
                          interpret=True)
    k1, v1 = tb(kp), tb(vp)
    got = _emulate(tb(q), k1, v1, tb(kn), tb(vn), torch.from_numpy(slots),
                   torch.from_numpy(bt), kv_lens, bs, scale, plan)
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                               np.asarray(jo, np.float32)[..., :hd], atol=1e-2)
    ref = _plain_f32(tb(q), k1, v1, torch.from_numpy(bt), torch.from_numpy(kv_lens), bs, scale)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
