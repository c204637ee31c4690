"""The paged decode kernel's plan and split arithmetic on the CPU.

``decode_plan`` cuts a block table's positions into the splits of the
decode kernel (``csrc/paged_attention.cu``): the grid (splits, n_kv, B)
must hold at least 2 blocks per SM at the serve shapes (Llama-3-8B and
Mixtral-8x7B: 8 KV heads, GQA group 4, tables up to 128 blocks of 64)
wherever splits of at least 4 tiles allow it, each split a whole number of
64-position tiles, the splits covering the table.
The plan reads static shapes only: the wrapper is driven here with a fake
kernel library on meta tensors, which hold no values, so no ``kv_lens`` or
other device value can be read on the host, and with CPU tensors of
different lengths, and it passes the kernel the same plan every time.

A plain model of the kernel's arithmetic (each split's 4 warps walking
16-position slices of the split's 64-position tiles with their own running
max and sum, the warps merged in order, then the splits' f32 partials merged
in split order, the exponent in base 2 with log2(e) folded into the scale) is
held against JAX ``paged_decode_attention_fused`` (interpret mode) and the
port's plain version in bf16 (atol 1e-2 on outputs of magnitude ~1: one
bf16 ulp), and against the plain version's f32 softmax before its bf16
rounding (atol 1e-5: the f32 sum order and exp2 against exp). The kernel's
tensor-core form of P (two bf16 parts) is checked on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.ops.paged_attention import paged_decode_attention_fused as jax_decode
from mistralrs_tpu_torch.kv.paged import write_kv
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops.paged_attention import (
    DECODE_MIN_TILES,
    DECODE_TILE,
    LOG2E,
    decode_plan,
    paged_decode_attention_fused,
)

HD = 128


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("w,bs", [(16, 64), (32, 64), (64, 64), (128, 64), (64, 16), (512, 16)])
@pytest.mark.parametrize("b", [1, 2, 4, 6, 8])
def test_plan_fills_the_card_at_serve_shapes(b, w, bs, sms):
    """Llama-3-8B and Mixtral-8x7B (8 KV heads, group 4): >= 2 blocks per
    SM wherever the table has the tiles for splits of DECODE_MIN_TILES,
    whole tiles a split and no shorter split than that, the splits covering
    the table with none wholly past its end."""
    n_kv, group = 8, 4
    plan = decode_plan(b, n_kv, group, w, bs, sms)
    tiles = -(-w * bs // DECODE_TILE)
    assert plan.positions % DECODE_TILE == 0
    assert plan.positions >= DECODE_TILE * min(tiles, DECODE_MIN_TILES)
    assert plan.splits * plan.positions >= w * bs > (plan.splits - 1) * plan.positions
    assert b * n_kv * plan.splits >= min(2 * sms, b * n_kv * (tiles // DECODE_MIN_TILES))


def test_plan_at_the_chip_smoke_rows():
    """The kernel table's row (B = 8, tables of 16 blocks of 64) and the two
    depth rows (B = 1 at 8192 positions, B = 8 at 4096 each): the splits
    that ``probes/split_plans.py`` measured within 3 % of the fastest it
    tried at each (PERF.md)."""
    assert decode_plan(8, 8, 4, 16, 64) == (256, 4)
    assert decode_plan(1, 8, 4, 128, 64) == (256, 32)
    assert decode_plan(8, 8, 4, 64, 64) == (704, 6)


def test_plan_refuses_groups_over_16():
    with pytest.raises(ValueError, match="GQA group"):
        decode_plan(1, 2, 17, 4, 16)


class _FakeLibrary:
    """Records the decode kernel's launch arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def mrt_paged_decode(self, *args):
        self.calls.append(args)
        return 0


def _launch(monkeypatch, device, kv_lens, b=4, n_kv=8, group=4, w=16, bs=64):
    fake = _FakeLibrary()
    monkeypatch.setattr(pa, "library", lambda: fake)
    monkeypatch.setattr(pa, "sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(pa, "split_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32, device=dev))
    bf, i32 = dict(dtype=torch.bfloat16, device=device), dict(dtype=torch.int32, device=device)
    s_total = (b * w + 1) * bs
    pa._decode_cuda(torch.zeros((b, n_kv * group, HD), **bf),
                    torch.zeros((n_kv, s_total, HD), **bf), torch.zeros((n_kv, s_total, HD), **bf),
                    torch.zeros((b, n_kv, HD), **bf), torch.zeros((b, n_kv, HD), **bf),
                    torch.zeros(b, **i32), torch.zeros((b, w), **i32),
                    kv_lens.to(device), bs, 0.1)
    (args,) = fake.calls
    return args[-6:-2]  # W, block_size, positions per split, splits


def test_plan_reads_no_device_value(monkeypatch):
    """On meta tensors (no values to read) and on CPU tensors of any
    lengths, the wrapper hands the kernel the same static plan."""
    want = _launch(monkeypatch, "meta", torch.zeros(4, dtype=torch.int32))
    assert want == (16, 64) + tuple(decode_plan(4, 8, 4, 16, 64))
    for lens in ([0, 0, 0, 0], [1, 1024, 64, 700], [1024] * 4):
        assert _launch(monkeypatch, "cpu", torch.tensor(lens, dtype=torch.int32)) == want


class _FakePrefillLibrary:
    """Records the prefill kernel's launch arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def mrt_paged_prefill(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("group", [3, 5, 6, 7, 12, 17, 65])
def test_prefill_wrapper_takes_groups_that_do_not_divide_64(monkeypatch, group):
    """The prefill wrapper hands the kernel any GQA group up to 64 (a query
    tile then holds 64 // group tokens; Qwen2.5-7B's 7, Qwen2.5-14B's 5),
    on meta tensors, with n_q and n_kv as given; a group over 64 (no token
    would fit a tile) raises, and the decode kernel's plan refuses groups
    over 16 (``test_plan_refuses_groups_over_16``)."""
    fake = _FakePrefillLibrary()
    monkeypatch.setattr(pa, "library", lambda: fake)
    monkeypatch.setattr(pa, "stream_ptr", lambda t: 0)
    b, t, n_kv, bs, w = 2, 20, 2, 16, 4
    bf, i32 = dict(dtype=torch.bfloat16, device="meta"), dict(dtype=torch.int32, device="meta")
    s_total = (b * w + 1) * bs
    args = (torch.zeros((b, t, n_kv * group, HD), **bf), torch.zeros((n_kv, s_total, HD), **bf),
            torch.zeros((n_kv, s_total, HD), **bf), torch.zeros((b, t, n_kv, HD), **bf),
            torch.zeros((b, t, n_kv, HD), **bf), torch.zeros((b, t), **i32),
            torch.zeros((b, w), **i32), torch.zeros(b, **i32), torch.zeros(b, **i32), bs, 0.1)
    if group > pa.PREFILL_MAX_GROUP:
        with pytest.raises(ValueError, match="GQA group"):
            pa._prefill_cuda(*args)
        assert not fake.calls
        return
    pa._prefill_cuda(*args)
    (call,) = fake.calls
    assert call[11:15] == (b, t, n_kv * group, n_kv)  # B, T, n_q, n_kv


# ---------------------------------------------------------------------------
# the kernel's split arithmetic, modelled in f32
# ---------------------------------------------------------------------------


def _emulate(q, kp, vp, k_new, v_new, slots, bt, kv_lens, bs, scale, plan, window=0,
             sinks=None):
    """The decode kernel's arithmetic, in f32 → out [B, n_q, hd] f32 (pools
    written in place, as the kernel writes them). With a ``window`` the walk
    starts at the tile holding ``kv_len - window`` and masks the positions
    below it; splits past the walk's last position exit (they add no
    partial). ``sinks`` [n_q] enter once per head: in the warps' merge when
    one split holds the walk, else in the merge of the splits."""
    write_kv(kp, vp, k_new, v_new, slots)
    b_, n_q, hd = q.shape
    n_kv = kp.shape[0]
    group = n_q // n_kv
    sl = scale * LOG2E
    out = torch.zeros((b_, n_q, hd))

    def with_sink(m, l, h):
        """(m, l) merged with the heads' sinks (m = sink, l = 1, no value)."""
        if sinks is None:
            return m, l, torch.ones_like(m)
        su = sinks[h * group:(h + 1) * group].float() / scale  # the scores' units
        mb = torch.maximum(m, su)
        f = torch.exp2((m - mb) * sl)
        return mb, l * f + torch.exp2((su - mb) * sl), f

    for b in range(b_):
        kv_len = int(kv_lens[b])
        start = (kv_len - window) // DECODE_TILE * DECODE_TILE if 0 < window < kv_len else 0
        p_lo = kv_len - window if window else 0
        live = max(1, -(-(kv_len - start) // plan.positions))
        assert live <= plan.splits
        pos = torch.arange(kv_len)
        phys = bt[b].long()[pos // bs] * bs + pos % bs
        for h in range(n_kv):
            keys, vals = kp[h, phys].float(), vp[h, phys].float()
            qh = q[b, h * group:(h + 1) * group].float()  # [group, hd]
            parts = []
            for s in range(live):
                lo = start + s * plan.positions
                hi = min(lo + plan.positions, kv_len)
                warps = []
                for w in range(4):
                    m = torch.full((group,), pa.NEG_INF)
                    l = torch.zeros(group)
                    acc = torch.zeros((group, hd))
                    for t0 in range(lo, hi, DECODE_TILE):
                        if t0 + 16 * w >= hi:
                            continue
                        idx = torch.arange(t0 + 16 * w, min(t0 + 16 * w + 16, hi))
                        sc = qh @ keys[idx].T  # raw scores [group, n]
                        sc = torch.where(idx[None] >= p_lo, sc, torch.full_like(sc, pa.NEG_INF))
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        alpha = torch.exp2((m - m_new) * sl)
                        p = torch.exp2(sc * sl - (m_new * sl)[:, None]) * (sc > 0.5 * pa.NEG_INF)
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ vals[idx]
                        m = m_new
                    warps.append((m, l, acc))
                mb = torch.stack([x[0] for x in warps]).amax(dim=0)
                f = [torch.exp2((x[0] - mb) * sl) for x in warps]
                parts.append((mb, sum(fi * x[1] for fi, x in zip(f, warps)),
                              sum(fi[:, None] * x[2] for fi, x in zip(f, warps))))
            mt = torch.stack([x[0] for x in parts]).amax(dim=0)
            f = [torch.exp2((x[0] - mt) * sl) for x in parts]
            l = sum(fi * x[1] for fi, x in zip(f, parts))
            acc = sum(fi[:, None] * x[2] for fi, x in zip(f, parts))
            _, l, f_sink = with_sink(mt, l, h)
            out[b, h * group:(h + 1) * group] = (
                acc * f_sink[:, None] / torch.clamp_min(l, 1e-20)[:, None])
    return out


def _plain_f32(q, kp, vp, bt, kv_lens, bs, scale, window=0, sinks=None):
    """The plain version's softmax on pools already written, before its
    bf16 rounding."""
    b, n_q, hd = q.shape
    n_kv = kp.shape[0]
    k, v = pa._gather_seq(kp, bt, bs), pa._gather_seq(vp, bt, bs)
    qg = q.float().reshape(b, n_kv, n_q // n_kv, hd) * scale
    pos = torch.arange(k.shape[2])
    lens = torch.as_tensor(kv_lens).long()[:, None]
    allowed = pos[None, :] < lens
    if window:
        allowed &= lens - 1 - pos[None, :] < window
    sink = pa._sink_rows(sinks, n_kv, n_q // n_kv)
    return pa._softmax_attend(qg, k, v, allowed[:, None, None, :], sink=sink).reshape(b, n_q, hd)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_split_arithmetic_matches_jax_and_plain(group):
    """Four rows over 1024-position tables of blocks of 16, in the 4 splits
    of 256 positions the plan gives on a 16-SM card: kv_len 0 with a
    dropped write, a row shorter than one split, one ending exactly on a
    split boundary, and one over every split (its write dropped: it reads
    the pool's old row at its last position)."""
    n_kv, bs, w, b = 2, 16, 64, 4
    n_q = n_kv * group
    plan = decode_plan(b, n_kv, group, w, bs, sms=16)
    assert plan == (256, 4)
    rng = np.random.default_rng(group)
    s_total = (b * w + 1) * bs
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    kv_lens = np.array([0, 100, 512, 1000], np.int32)
    slots = np.array([-1, bt[1, 99 // bs] * bs + 99 % bs, bt[2, 511 // bs] * bs + 511 % bs, -1],
                     np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kp, vp = f32(b, n_q, HD), f32(n_kv, s_total, HD), f32(n_kv, s_total, HD)
    kn, vn = f32(b, n_kv, HD), f32(b, n_kv, HD)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    scale = 1.0 / math.sqrt(HD)

    jo, _, _ = jax_decode(jb(q), jb(kp), jb(vp), jb(kn), jb(vn), jnp.asarray(slots),
                          jnp.asarray(bt), jnp.asarray(kv_lens), block_size=bs, interpret=True)
    k1, v1 = tb(kp), tb(vp)
    got = _emulate(tb(q), k1, v1, tb(kn), tb(vn), torch.from_numpy(slots),
                   torch.from_numpy(bt), kv_lens, bs, scale, plan)
    k2, v2 = tb(kp), tb(vp)
    plain = paged_decode_attention_fused(
        tb(q), k2, v2, tb(kn), tb(vn), torch.from_numpy(slots), torch.from_numpy(bt),
        torch.from_numpy(kv_lens), block_size=bs, scale=scale)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert (got[0] == 0).all()  # kv_len 0: zeros
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                               np.asarray(jo, np.float32), atol=1e-2)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), plain.float().numpy(),
                               atol=1e-2)
    ref = _plain_f32(tb(q), k1, v1, torch.from_numpy(bt), torch.from_numpy(kv_lens), bs, scale)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("plan", [pa.DecodePlan(64, 3), pa.DecodePlan(192, 1)])
@pytest.mark.parametrize("group", [1, 8])
def test_split_merge_with_sinks_matches_jax(group, plan):
    """gpt-oss's sliding layers: a window of 128 and a sink per head, at
    head_dim 64. Plans of 3 splits of 64 positions (the walk covers at most
    window + 63) and of one split of 192 (``decode_plan``'s at this window):
    rows of kv_len 0, 100 (no window bite), 129 (start 0, 3 live splits),
    256 (start 128: only 2 of the 3 splits hold a position, the third one
    exits and must add no second l = 1) and 300 (start 128, a first tile
    partly below the window). The model (the sink merged once per head)
    against JAX ``paged_decode_attention_fused`` in interpret mode with its
    rows padded to 128 (bf16, atol 1e-2) and against the plain version's
    f32 softmax (atol 1e-5)."""
    hd, n_kv, bs, w, window = 64, 2, 16, 20, 128
    n_q = n_kv * group
    kv_lens = np.array([0, 100, 129, 256, 300], np.int32)
    b = len(kv_lens)
    rng = np.random.default_rng(100 + group)
    s_total = (b * w + 1) * bs
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    slots = np.array([-1] + [bt[i, (n - 1) // bs] * bs + (n - 1) % bs
                             for i, n in enumerate(kv_lens) if i], np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kp, vp = f32(b, n_q, hd), f32(n_kv, s_total, hd), f32(n_kv, s_total, hd)
    kn, vn = f32(b, n_kv, hd), f32(b, n_kv, hd)
    # sinks of N(4, 2^2): against ~100 positions of scores N(0, 1) they take
    # a good share of the softmax
    sinks = (rng.standard_normal(n_q) * 2 + 4).astype(np.float32)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    pad = lambda a: jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 128 - hd)]),  # noqa: E731
                                jnp.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    jo, _, _ = jax_decode(pad(q), pad(kp), pad(vp), pad(kn), pad(vn), jnp.asarray(slots),
                          jnp.asarray(bt), jnp.asarray(kv_lens), window, 0, None,
                          jnp.asarray(sinks), block_size=bs, scale=scale, interpret=True)
    k1, v1 = tb(kp), tb(vp)
    got = _emulate(tb(q), k1, v1, tb(kn), tb(vn), torch.from_numpy(slots), torch.from_numpy(bt),
                   kv_lens, bs, scale, plan, window, torch.from_numpy(sinks))
    assert (got[0] == 0).all()  # kv_len 0: zeros, sink or not
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                               np.asarray(jo, np.float32)[..., :hd], atol=1e-2)
    ref = _plain_f32(tb(q), k1, v1, torch.from_numpy(bt), kv_lens, bs, scale, window,
                     torch.from_numpy(sinks))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    no_sink = _plain_f32(tb(q), k1, v1, torch.from_numpy(bt), kv_lens, bs, scale, window)
    assert (ref - no_sink).abs().max() > 0.05  # the sinks bite
