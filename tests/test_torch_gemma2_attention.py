"""Gemma-2's attention options in the port's paged kernels, on the CPU:
sliding windows, the attention logit softcap and head_dim 256, held
against the JAX package's Pallas kernels (``tests/test_torch_gemma2.py``
holds the model, the HF loader and the engine).

* The plain paged decode against JAX ``paged_decode_attention_fused``
  (interpret mode) in f32 at head_dim 128 and 256, GQA groups 1, 2 and 4,
  softcap 0 and 50, windows 0, 1, 5, 64, 100 and one wider than every
  kv_len, a kv_len of 0 and a dropped write: atol 1e-4 (f32, the same sums
  but exp2 against exp and another order).
* The plain paged prefill against JAX ``paged_prefill_attention_fused``
  (interpret mode) in bf16 with the same options, a chunk straddling the
  window's edge, rows with n_valid < T and pasts not a multiple of the
  block: atol 1e-2 (the JAX kernel rounds P, and without a softcap
  q * scale * log2(e), to bf16; values of magnitude ~1).
* The decode kernel's windowed split plan: a model of its walk (the tile
  holding ``kv_len - window`` first, the plan's splits from there, merged
  in order) against the plain version (atol 1e-5, f32), and the wrappers'
  launch arguments through a fake kernel library on ``meta`` tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import init_random_weights, kernel_workspace, layer_windows
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    DECODE_TILE,
    LOG2E,
    decode_counters,
    decode_plan,
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

WINDOWS = (0, 1, 5, 64, 100, 1000)


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels
# ---------------------------------------------------------------------------

BS, W, N_KV = 16, 8, 2


def _slot(bt, b, p):
    return int(bt[b, p // BS] * BS + p % BS)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [128, 256])
def test_plain_decode_matches_pallas(hd, group, softcap):
    """f32 pools and queries, scale 1 (scores ~N(0, hd), so a softcap of 50
    bites); rows: kv_len 0, one position, a dropped write, a table's worth."""
    rng = np.random.default_rng(hd + group)
    b, n_q = 5, N_KV * group
    s_total = (b * W + 1) * BS
    kp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    vp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    kv_lens = np.array([0, 1, 37, 100, W * BS], np.int32)
    q = rng.standard_normal((b, n_q, hd)).astype(np.float32)
    kn = rng.standard_normal((b, N_KV, hd)).astype(np.float32)
    vn = rng.standard_normal((b, N_KV, hd)).astype(np.float32)
    slots = np.array([-1, _slot(bt, 1, 0), -1, _slot(bt, 3, 99), _slot(bt, 4, W * BS - 1)],
                     np.int32)
    f32 = torch.float32
    for window in WINDOWS:
        jo, _, _ = jax_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                              jnp.asarray(vn), jnp.asarray(slots), jnp.asarray(bt),
                              jnp.asarray(kv_lens), window, block_size=BS, scale=1.0,
                              softcap=softcap, interpret=True)
        reset_counts()
        to = paged_decode_attention_fused(
            _t(q, f32), _t(kp, f32), _t(vp, f32), _t(kn, f32), _t(vn, f32),
            torch.from_numpy(slots), torch.from_numpy(bt), torch.from_numpy(kv_lens),
            block_size=BS, scale=1.0, window=window, softcap=softcap)
        name = "paged_decode_hd256" if hd == 256 else "paged_decode"
        assert COUNTS[name + "_plain"] == 1 and sum(COUNTS.values()) == 1
        assert (to[0] == 0).all()  # kv_len 0: zeros
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                   err_msg=f"window {window}")


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [128, 256])
def test_plain_prefill_matches_pallas(hd, group, softcap):
    """bf16, scale 1/16 (exact in bf16); with a softcap the queries are 8x
    larger, so that it bites. V rows are N(0, 1/16): a narrow window's
    output is one or a few of them, and at magnitudes below 1 atol 1e-2
    spans a bf16 ulp of the output's own rounding and the JAX kernel's
    rounding of P. 3 rows of a 20-token chunk: 20 valid on a past
    of 25 (the chunk straddles windows 5 and 1's edges), 7 valid on none, 12
    valid on 40 (rows 1 and 2: n_valid < T)."""
    rng = np.random.default_rng(10 * hd + group)
    b, t, n_q = 3, 20, N_KV * group
    s_total = (b * W + 1) * BS
    kp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    vp = rng.standard_normal((N_KV, s_total, hd)).astype(np.float32)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    n_valid = np.array([20, 7, 12], np.int32)
    kv_lens = n_valid + np.array([25, 0, 40], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((b, t), -1, np.int32)
    for i in range(b):
        slots[i, :n_valid[i]] = [_slot(bt, i, ctx[i] + j) for j in range(n_valid[i])]
    q = rng.standard_normal((b, t, n_q, hd)).astype(np.float32) * (8.0 if softcap else 1.0)
    kn = rng.standard_normal((b, t, N_KV, hd)).astype(np.float32)
    vn = rng.standard_normal((b, t, N_KV, hd)).astype(np.float32) * 0.25
    vp *= 0.25
    bf = torch.bfloat16
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    for window in WINDOWS:
        jo, _, _ = jax_prefill(jb(q), jb(kp), jb(vp), jb(kn), jb(vn), jnp.asarray(slots),
                               jnp.asarray(bt), jnp.asarray(kv_lens), jnp.asarray(n_valid),
                               window, block_size=BS, scale=1 / 16, softcap=softcap,
                               interpret=True)
        reset_counts()
        to = paged_prefill_attention_fused(
            _t(q, bf), _t(kp, bf), _t(vp, bf), _t(kn, bf), _t(vn, bf),
            torch.from_numpy(slots), torch.from_numpy(bt), torch.from_numpy(kv_lens),
            torch.from_numpy(n_valid), block_size=BS, scale=1 / 16, window=window,
            softcap=softcap)
        name = "paged_prefill_hd256" if hd == 256 else "paged_prefill"
        assert COUNTS[name + "_plain"] == 1 and sum(COUNTS.values()) == 1
        jo = np.asarray(jo, np.float32)
        for i in range(b):  # rows past n_valid are never read
            np.testing.assert_allclose(to.float().numpy()[i, :n_valid[i]], jo[i, :n_valid[i]],
                                       atol=1e-2, err_msg=f"window {window} row {i}")


# ---------------------------------------------------------------------------
# the windowed decode plan and the wrappers' launch arguments
# ---------------------------------------------------------------------------


def _walk_start(kv_len: int, window: int) -> int:
    """The decode kernel's first position: the tile holding kv_len - window."""
    return (kv_len - window) // DECODE_TILE * DECODE_TILE if 0 < window < kv_len else 0


@pytest.mark.parametrize("window", [1, 63, 64, 65, 100, 4096, 5000])
@pytest.mark.parametrize("w,bs", [(16, 64), (128, 64), (64, 16)])
def test_windowed_plan_covers_every_walk(w, bs, window):
    """For every kv_len a table of w blocks holds, the windowed walk needs
    no more splits than the plan gives, and the plan never splits more
    positions than the unwindowed one (at most window + one tile)."""
    plan = decode_plan(8, 8, 2, w, bs, 132, window)
    full = decode_plan(8, 8, 2, w, bs, 132)
    assert plan.positions % DECODE_TILE == 0
    assert plan.splits * plan.positions <= max(full.splits * full.positions,
                                               window + 2 * DECODE_TILE)
    for kv_len in range(0, w * bs + 1):
        walk = kv_len - _walk_start(kv_len, window)
        assert max(1, -(-walk // plan.positions)) <= plan.splits
        assert walk <= window + DECODE_TILE - 1


def _emulate_windowed(q, k, v, kv_lens, window, softcap, scale, plan):
    """The decode kernel's windowed walk in f32 on gathered K/V [B, n_kv,
    P, hd]: splits of plan.positions from the tile holding kv_len - window,
    each a flash pass over its positions masked below kv_len - window, the
    partials merged in split order."""
    b_, n_q, hd = q.shape
    n_kv = k.shape[1]
    group = n_q // n_kv
    e_mul, cap_in = pa._exponent(scale, softcap)
    out = torch.zeros((b_, n_q, hd))
    for b in range(b_):
        kv_len = int(kv_lens[b])
        start = _walk_start(kv_len, window)
        lo = kv_len - window if window else 0
        live = max(1, -(-(kv_len - start) // plan.positions))
        assert live <= plan.splits
        for h in range(n_kv):
            qh = q[b, h * group:(h + 1) * group]
            parts = []
            for s in range(live):
                p0 = start + s * plan.positions
                idx = torch.arange(p0, min(p0 + plan.positions, kv_len))
                sc = qh @ k[b, h, idx].T
                if softcap:
                    sc = softcap * torch.tanh(sc * cap_in)
                sc = torch.where(idx[None] >= lo, sc, torch.full_like(sc, pa.NEG_INF))
                m = sc.amax(dim=1) if len(idx) else torch.full((group,), pa.NEG_INF)
                p = torch.where(sc > 0.5 * pa.NEG_INF, torch.exp2((sc - m[:, None]) * e_mul),
                                torch.zeros_like(sc))
                parts.append((m, p.sum(dim=1), p @ v[b, h, idx]))
            mt = torch.stack([x[0] for x in parts]).amax(dim=0)
            f = [torch.exp2((x[0] - mt) * e_mul) for x in parts]
            l = sum(fi * x[1] for fi, x in zip(f, parts))
            acc = sum(fi[:, None] * x[2] for fi, x in zip(f, parts))
            out[b, h * group:(h + 1) * group] = acc / torch.clamp_min(l, 1e-20)[:, None]
    return out


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [5, 64, 100, 300])
def test_windowed_split_arithmetic_matches_plain(window, softcap):
    """Rows of 0 to 1000 positions over 1024-position tables of blocks of
    16, in the windowed plan of a 16-SM card: the walk from the window's
    tile, merged in split order, agrees with the plain version's f32
    softmax (atol 1e-5)."""
    n_kv, group, bs, w, hd = 2, 2, 16, 64, 128
    kv_lens = torch.tensor([0, 3, 100, 128, 129, 640, 1000], dtype=torch.int32)
    b = len(kv_lens)
    plan = decode_plan(b, n_kv, group, w, bs, 16, window)
    rng = np.random.default_rng(window)
    s_total = (b * w + 1) * bs
    kp = torch.from_numpy(rng.standard_normal((n_kv, s_total, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_kv, s_total, hd)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, n_kv * group, hd)).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(b * w).astype(np.int32).reshape(b, w))
    k, v = pa._gather_seq(kp, bt, bs), pa._gather_seq(vp, bt, bs)
    scale = 0.3
    got = _emulate_windowed(q, k, v, kv_lens, window, softcap, scale, plan)
    pos = torch.arange(k.shape[2])
    lens = kv_lens.long()[:, None]
    allowed = (pos[None] < lens) & (lens - 1 - pos[None] < window)
    ref = pa._softmax_attend(q.reshape(b, n_kv, group, hd) * scale, k, v,
                             allowed[:, None, None], softcap=softcap).reshape(b, -1, hd)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


class _FakeLibrary:
    """Records the paged kernels' launch arguments instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("mrt_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls[name] = args
            return 0

        return fn


def _fake(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(pa, "library", lambda: fake)
    monkeypatch.setattr(pa, "sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(pa, "split_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32, device=dev))
    return fake


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_launch_arguments_carry_window_and_softcap(monkeypatch, softcap):
    """Gemma-2-9B's attention (16/8 heads, head_dim 256) on meta tensors:
    the decode launch gets the windowed plan, the window, the softcap, the
    tanh's input scale and the exponent's multiplier; the prefill launch the
    same options; both count under their head_dim-256 names."""
    fake = _fake(monkeypatch)
    b, n_kv, n_q, hd, bs, w, win = 8, 8, 16, 256, 64, 128, 4096
    bf, i32 = dict(dtype=torch.bfloat16, device="meta"), dict(dtype=torch.int32, device="meta")
    s_total = (b * w + 1) * bs
    pool = torch.empty((n_kv, s_total, hd), **bf)
    scale = 256 ** -0.5
    reset_counts()
    pa._decode_cuda(torch.empty((b, n_q, hd), **bf), pool, pool, torch.empty((b, n_kv, hd), **bf),
                    torch.empty((b, n_kv, hd), **bf), torch.empty(b, **i32),
                    torch.empty((b, w), **i32), torch.empty(b, **i32), bs, scale, window=win,
                    softcap=softcap)
    args = fake.calls["mrt_paged_decode"]
    plan = decode_plan(b, n_kv, 2, w, bs, 132, win)
    assert plan != decode_plan(b, n_kv, 2, w, bs, 132)
    assert args[11] is None  # no sinks
    assert args[12:16] == (b, n_q, n_kv, hd)
    assert args[16] == win and args[17] == softcap
    assert args[-6:-2] == (w, bs) + tuple(plan)
    if softcap:
        assert args[18] == pytest.approx(scale / softcap) and args[-2] == pytest.approx(LOG2E)
    else:
        assert args[18] == 0.0 and args[-2] == pytest.approx(scale * LOG2E)
    t = 32
    pa._prefill_cuda(torch.empty((2, t, n_q, hd), **bf), pool, pool,
                     torch.empty((2, t, n_kv, hd), **bf), torch.empty((2, t, n_kv, hd), **bf),
                     torch.empty((2, t), **i32), torch.empty((2, w), **i32),
                     torch.empty(2, **i32), torch.empty(2, **i32), bs, scale, window=win,
                     softcap=softcap)
    args = fake.calls["mrt_paged_prefill"]
    assert args[10] is None  # no sinks
    assert args[11:20] == (2, t, n_q, n_kv, hd, win, softcap, args[18], s_total)
    assert args[-4:-1] == (w, bs, pytest.approx(LOG2E if softcap else scale * LOG2E))
    assert COUNTS["paged_decode_hd256"] == 1 and COUNTS["paged_prefill_hd256"] == 1
    assert COUNTS["paged_decode"] == 0 and COUNTS["paged_prefill"] == 0


def test_kernel_workspace_counts_windowed_plans():
    """A model whose every layer slides (Mistral's uniform window) reserves
    the counters of its windowed plans, at every width."""
    cfg = ModelConfig(arch="mistral", vocab_size=8, hidden_size=8, intermediate_size=8,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                      sliding_window=64)
    weights = init_random_weights(cfg, device="cpu")
    assert layer_windows(cfg).tolist() == [64, 64]
    widths = [2, 32, 128]
    _, counters = kernel_workspace(weights, cfg, 8, [8], widths, 64, 132)
    want = max(decode_counters(decode_plan(8, 2, 2, w, 64, 132, 64), 8, 2) for w in widths)
    assert counters == want
