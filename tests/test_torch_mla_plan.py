"""The MLA decode kernel's plan and split arithmetic on the CPU.

``mla_plan`` sets the splits of the MLA decode kernel
(``csrc/mla_attention.cu``): the blocks that share each (sequence, head
tile), split s taking the sequence's 32-position tiles s, s + splits, ...,
in thread block clusters of at most 16 splits. Each split walks at least
``MLA_MIN_TILES`` tiles of a full table unless the table is shorter (less
one where the splits are rounded up to whole clusters), the splits cover the
table in whole tiles, and the grid (splits, B, head tiles) holds about one
block per SM at DeepSeek-V2-Lite's serve shapes (16 heads, tables of 32-128
blocks of 64, B 1-8) wherever splits that long allow it. The plan reads
static shapes only: the wrapper is driven here with a fake kernel library on
meta tensors, which hold no values, so no ``kv_lens`` or other device value
can be read on the host, and with CPU tensors of different lengths, and it
passes the kernel the same plan every time.

A plain model of the kernel's arithmetic (each split walking its tiles in
turn, the scores summed over the four warps' depth slices in warp order, the
online softmax in base 2 with log2(e) folded into the scale, P rounded once
to bf16 and the sum l taken over the rounded P, then the splits' f32
partials merged in split order within each cluster and the clusters'
results in cluster order; a sequence of one tile written by its only split)
is held against JAX ``mla_decode_fused`` (interpret mode) and the port's
plain version in bf16 (atol 2e-2 on outputs of magnitude ~1: P's bf16
rounding, at most 2^-9 of each weight, and the bf16 rounding of both
outputs, the card test's tolerance), and, with P left in f32, against the
plain version's f32 softmax before its bf16 rounding (atol 1e-5: the f32
sum order and exp2 against exp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.ops.mla_attention import mla_decode_fused as jax_mla
from mistralrs_tpu_torch.ops import mla_attention as ma
from mistralrs_tpu_torch.ops.mla_attention import (
    MLA_MAX_CLUSTER,
    MLA_MIN_TILES,
    MLA_TILE,
    LOG2E,
    clustered,
    mla_blocks,
    mla_decode,
    mla_plan,
)
from mistralrs_tpu_torch.ops.paged_attention import NEG_INF, _softmax_attend


def _check_plan(plan, w, bs):
    """Whole clusters of at most 16 splits, as few as can be; the tiles split
    s of a full table walks (s, s + splits, ...) cover the table once, none
    fewer than the floor (less one for the rounding to whole clusters)
    unless the table is shorter."""
    tiles = -(-w * bs // MLA_TILE)
    assert 1 <= plan.cluster <= MLA_MAX_CLUSTER and plan.splits % plan.cluster == 0
    assert plan.splits // plan.cluster == -(-plan.splits // MLA_MAX_CLUSTER)
    walks = [len(range(s, tiles, plan.splits)) for s in range(plan.splits)]
    assert sum(walks) == tiles
    assert plan.splits == 1 or min(walks) >= MLA_MIN_TILES - 1
    return tiles


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("b", [1, 2, 4, 6, 8])
def test_plan_fills_the_card_at_serve_shapes(b, w, sms):
    """DeepSeek-V2-Lite (16 heads: one block per sequence and split), tables
    of ``w`` blocks of 64: a block per SM (less at most one per sequence)
    wherever the table has the tiles for splits of MLA_MIN_TILES, and no
    more than the SMs hold, whole tiles a split and none shorter, the splits
    covering the table."""
    z = mla_blocks(16, 512)
    assert z == 1
    plan = mla_plan(b, z, w, 64, sms)
    tiles = _check_plan(plan, w, 64)
    assert b * z * plan.splits >= min(sms - b * z + 1, b * z * (tiles // MLA_MIN_TILES))
    assert b * z * plan.splits <= sms + b * z * (plan.splits // plan.cluster)


def test_plan_at_the_chip_smoke_rows():
    """The kernel table's rows: B = 8 over tables of 32 blocks of 64 (the
    serve step's tables too) and of 64, one cluster of 16 splits a sequence;
    B = 1 at 8192 positions, four clusters of 16. The splits that
    ``probes/split_plans.py`` measured within 2 % of the fastest it tried at
    each (PERF.md)."""
    assert mla_plan(8, 1, 32, 64) == (16, 16)
    assert mla_plan(8, 1, 64, 64) == (16, 16)
    assert mla_plan(1, 1, 128, 64) == (64, 16)


@pytest.mark.parametrize("nh,rank,z", [(16, 512, 1), (20, 512, 2), (128, 512, 8),
                                       (16, 576, 2), (4, 64, 1)])
def test_blocks_per_split(nh, rank, z):
    """Head tiles of 16 (a last partial one for 20 heads; DeepSeek-V2/V3's
    128 heads take 8) times column groups of 512 rank columns."""
    assert mla_blocks(nh, rank) == z


@pytest.mark.parametrize("splits,want", [(1, (1, 1)), (16, (16, 16)), (17, (18, 9)),
                                         (20, (20, 10)), (64, (64, 16)), (65, (65, 13))])
def test_clusters(splits, want):
    """Splits in the fewest clusters of at most 16, rounded up to whole
    clusters as even as they come."""
    assert clustered(splits) == want


@pytest.mark.parametrize("w,bs", [(1, 16), (3, 16), (5, 64), (512, 16), (256, 64)])
def test_plan_covers_odd_tables(w, bs):
    """Tables shorter than one split's floor, and long ones at several head
    tiles: whole tiles, the table covered."""
    for b, z in ((1, 1), (3, 8), (8, 2)):
        _check_plan(mla_plan(b, z, w, bs), w, bs)


class _FakeLibrary:
    """Records the kernel's launch arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def mrt_mla_decode(self, *args):
        self.calls.append(args)
        return 0


def _launch(monkeypatch, device, kv_lens, b=4, nh=20, d=576, rank=512, w=32, bs=64):
    fake = _FakeLibrary()
    counters = []
    monkeypatch.setattr(ma, "library", lambda: fake)
    monkeypatch.setattr(ma, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ma, "stream_ptr", lambda t: 0)

    def split_counters(dev, n):
        counters.append(n)
        return torch.zeros(n, dtype=torch.int32, device=dev)

    monkeypatch.setattr(ma, "split_counters", split_counters)
    bf, i32 = dict(dtype=torch.bfloat16, device=device), dict(dtype=torch.int32, device=device)
    s_total = (b * w + 1) * bs
    out = ma._mla_cuda(torch.zeros((b, nh, d), **bf), torch.zeros((s_total, d), **bf),
                       torch.zeros((b, d), **bf), torch.zeros(b, **i32),
                       torch.zeros((b, w), **i32), kv_lens.to(device), bs, rank, 0.1)
    assert tuple(out.shape) == (b, nh, rank)
    (args,) = fake.calls
    return args[-6:-2], counters  # W, block_size, splits, cluster


@pytest.mark.parametrize("b,w", [(4, 32), (1, 256)])
def test_plan_reads_no_device_value(monkeypatch, b, w):
    """On meta tensors (no values to read) and on CPU tensors of any
    lengths, the wrapper hands the kernel the same static plan (one cluster
    at B = 4, several at B = 1 and 16384 positions, which take the cross-
    cluster merge's counters: one per slice)."""
    want, counters = _launch(monkeypatch, "meta", torch.zeros(b, dtype=torch.int32), b=b, w=w)
    plan = mla_plan(b, 2, w, 64)
    assert want == (w, 64) + tuple(plan)
    assert counters == ([b * 2 * plan.cluster] if plan.splits > plan.cluster else [])
    assert (plan.splits > plan.cluster) == (b == 1)
    for lens in ([0] * b, [1, 2048, 64, 700][:b], [w * 64] * b):
        got, _ = _launch(monkeypatch, "cpu", torch.tensor(lens, dtype=torch.int32), b=b, w=w)
        assert got == want


# ---------------------------------------------------------------------------
# the kernel's split arithmetic, modelled in f32
# ---------------------------------------------------------------------------


def _merge(parts, sl):
    """(m, l, acc) partials merged in order, as the kernel's merges do."""
    mb = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(mb)
    acc = torch.zeros_like(parts[0][2])
    for m, li, a in parts:
        f = torch.exp2((m - mb) * sl)
        l = f * li + l
        acc = f[:, None] * a + acc
    return mb, l, acc


def _emulate(q, plane, row_new, slots, bt, kv_lens, bs, rank, scale, plan, round_p=True):
    """The MLA kernel's arithmetic in f32 → out [B, nh, rank] f32 (the pool
    plane written in place, as the kernel writes it)."""
    s_total, d = plane.shape
    plane[torch.where(slots < 0, s_total - 1, slots).long()] = row_new
    ksteps = -(-d // 16)
    cuts = [16 * (w * ksteps // 4) for w in range(5)]  # the warps' depth slices
    sl = scale * LOG2E
    b_, nh, _ = q.shape
    out = torch.zeros((b_, nh, rank))
    for b in range(b_):
        kv = int(kv_lens[b])
        tiles = -(-kv // MLA_TILE)
        pos = torch.arange(kv)
        rows = plane[bt[b].long()[pos // bs] * bs + pos % bs].float()
        qb = q[b].float()
        parts = []
        for s in range(min(plan.splits, tiles)):
            m = torch.full((nh,), NEG_INF)
            l = torch.zeros(nh)
            acc = torch.zeros((nh, rank))
            for t in range(s, tiles, plan.splits):
                idx = torch.arange(t * MLA_TILE, min((t + 1) * MLA_TILE, kv))
                sc = torch.zeros((nh, len(idx)))
                for a, e in zip(cuts, cuts[1:]):
                    sc = sc + qb[:, a:e] @ rows[idx, a:e].T
                m_new = torch.maximum(m, sc.amax(dim=1))
                alpha = torch.exp2((m - m_new) * sl)
                p = torch.exp2(sc * sl - (m_new * sl)[:, None])
                if round_p:
                    p = p.to(torch.bfloat16).float()
                l = l * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + p @ rows[idx, :rank]
                m = m_new
            parts.append((m, l, acc))
        if len(parts) > 1:  # merged in split order in each cluster, then the clusters
            clusters = [_merge(parts[i:i + plan.cluster], sl)
                        for i in range(0, len(parts), plan.cluster)]
            _, l, acc = clusters[0] if len(clusters) == 1 else _merge(clusters, sl)
        elif not parts:  # kv_len 0
            l, acc = torch.zeros(nh), torch.zeros((nh, rank))
        out[b] = acc / torch.clamp_min(l, 1e-20)[:, None]
    return out


def _plain_f32(q, plane, bt, kv_lens, bs, rank, scale):
    """The plain version's softmax on a pool already written, before its
    bf16 rounding."""
    b = q.shape[0]
    gather = (bt.long()[:, :, None] * bs + torch.arange(bs)).reshape(b, -1)
    keys = plane[gather].float()[:, None]
    pos = torch.arange(keys.shape[2])
    allowed = (pos[None, :] < kv_lens[:, None])[:, None, None, :]
    return _softmax_attend(q.float()[:, None] * scale, keys, keys[..., :rank], allowed)[:, 0]


@pytest.mark.parametrize("splits", [None, 16, 5, 24, 34])
def test_split_arithmetic_matches_jax_and_plain(splits):
    """Four rows of 20 heads (two head tiles, the second partial) over
    1152-position tables of blocks of 16, rows of 72 (rank 64 + rope 8: a
    depth that is no multiple of 16, cut unevenly into the warps' slices),
    at the plan the kernel gets on an H100 (None), at the largest cluster
    (16 splits), at 5 (splits walking different numbers of tiles) and at 24
    and 34 (two and three clusters, the last with splits that have no tile):
    kv_len 0 with a dropped write, a row of 4 tiles, one of exactly 16
    tiles, and one over every split (its write dropped: it reads the pool's
    old row at its last position)."""
    b, nh, rank, rope, bs, w = 4, 20, 64, 8, 16, 72
    d = rank + rope
    plan = mla_plan(b, mla_blocks(nh, rank), w, bs, 132)
    if splits is not None:
        plan = clustered(splits)
    rng = np.random.default_rng(11)
    s_total = (b * w + 1) * bs
    bt = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    kv_lens = np.array([0, 100, 512, 1150], np.int32)
    slots = np.array([-1, bt[1, 99 // bs] * bs + 99 % bs, bt[2, 511 // bs] * bs + 511 % bs, -1],
                     np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, pool, rows = f32(b, nh, d), f32(s_total, d), f32(b, d)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    scale = 0.1

    def pad(a):
        return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 128 - d)]), jnp.bfloat16)

    jo, jpool = jax_mla(pad(q), pad(pool)[None], pad(rows), jnp.asarray(slots), jnp.asarray(bt),
                        jnp.asarray(kv_lens), 0, rank=rank, block_size=bs, scale=scale,
                        interpret=True)
    p1 = tb(pool)
    got = _emulate(tb(q), p1, tb(rows), torch.from_numpy(slots), torch.from_numpy(bt),
                   kv_lens, bs, rank, scale, plan)
    p2 = tb(pool)
    plain = mla_decode(tb(q), p2, tb(rows), torch.from_numpy(slots), torch.from_numpy(bt),
                       torch.from_numpy(kv_lens), rank=rank, block_size=bs, scale=scale)
    assert torch.equal(p1, p2)
    # the pool but the trash row, which takes two dropped writes
    np.testing.assert_array_equal(p1[:-1].float().numpy(),
                                  np.asarray(jpool[0], np.float32)[:-1, :d])
    assert (got[0] == 0).all()  # kv_len 0: zeros
    got_b = got.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got_b, np.asarray(jo, np.float32), atol=2e-2)
    np.testing.assert_allclose(got_b, plain.float().numpy(), atol=2e-2)
    exact = _emulate(tb(q), tb(pool), tb(rows), torch.from_numpy(slots), torch.from_numpy(bt),
                     kv_lens, bs, rank, scale, plan, round_p=False)
    ref = _plain_f32(tb(q), p1, torch.from_numpy(bt), torch.from_numpy(kv_lens), bs, rank, scale)
    np.testing.assert_allclose(exact.numpy(), ref.numpy(), atol=1e-5)
