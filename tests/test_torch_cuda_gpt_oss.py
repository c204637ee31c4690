"""gpt-oss's kernel options on the card (marked ``cuda``; they skip where
there is no GPU): attention sinks and head_dim 64 in the paged decode and
prefill kernels, and the dense grouped kernel at K an odd multiple of 64,
each against its plain PyTorch version. On the card:

    python -m pytest tests/test_torch_cuda_gpt_oss.py -q -m cuda --noconftest

* Both attention kernels with sinks (f32 per head, N(4, 1): they take a
  good share of the softmax) at head_dim 64, 128 and 256, GQA groups 1, 4,
  8 and 16, blocks of 16 and 64, windows 0, 100 and 128, softcap 0 and 30:
  bf16 outputs within 2e-2 of the plain version (the tolerance of
  ``tests/test_torch_cuda_kernels.py``), a second call bit-equal, the pools
  bit-equal but at the trash slot; the plain version without the sinks
  differs by more than 0.1.
* The decode kernel at plans of more splits than a windowed row fills (a
  split past the walk's end exits and adds no second sink), given through
  the wrapper's ``plan`` argument.
* The dense grouped kernel at K = 2880 (gpt-oss) and 448 (7 x 64), N of
  5760, 2880 and 272 (not a multiple of the prefill body's 256 columns),
  both bodies (16- and 64-row tiles), against its plain version (1e-2 of
  the largest |value|); and gpt-oss's expert MLP on it.
* A 2-layer gpt-oss (one sliding layer, window 8, and one full; head_dim
  64, GQA group 8, sinks, biases, YaRN, 8 experts top-4 at K = 320 and
  192) through the kernels and the plain versions: logits within 5e-2 of
  the largest.
"""

import math

import pytest
import torch

from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models import llama
from mistralrs_tpu_torch.models.llama import forward_paged
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import (
    build_groups,
    dense_matmul_grouped,
    gpt_oss_grouped_mlp,
    grouped_tile,
)
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

pytestmark = pytest.mark.cuda

OPTIONS = ((0, 0.0), (100, 0.0), (128, 30.0))  # (window, softcap)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _name(kernel, hd):
    return f"{kernel}_hd{hd}" if hd in (64, 256) else kernel


def _sinks(g, n_q, dev):
    return torch.randn(n_q, generator=g, device=dev).add_(4.0)


def _bites(with_sinks, without, mask=None):
    d = (with_sinks.float() - without.float()).abs()
    return (d if mask is None else d[mask]).max().item() > 0.1


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_sinks_match_plain(dev, hd, group, bs):
    """B = 8 on 1024-position tables: kv_len 0 (its write dropped), 1, 63,
    64, 65, 700 (its write dropped), 1000 and 1024."""
    n_kv, w = 2, 1024 // bs
    kv_lens = torch.tensor([0, 1, 63, 64, 65, 700, 1000, 1024], device=dev, dtype=torch.int32)
    b = len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(hd + group + bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    s_total = (b * w + 1) * bs
    kp, vp = (torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((b, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    sinks = _sinks(g, n_kv * group, dev)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    slots[0] = slots[5] = -1
    name = _name("paged_decode", hd)
    args = (kn, vn, slots, bt, kv_lens)
    for window, softcap in OPTIONS:
        mine, ref_p, ctl_p = ([kp.clone(), vp.clone()] for _ in range(3))
        kw = dict(block_size=bs, window=window, softcap=softcap)
        reset_counts()
        got = paged_decode_attention_fused(q, *mine, *args, **kw, sinks=sinks)
        again = paged_decode_attention_fused(q, *mine, *args, **kw, sinks=sinks)
        ref = paged_decode_attention_fused(q, *ref_p, *args, **kw, sinks=sinks, plain=True)
        ctl = paged_decode_attention_fused(q, *ctl_p, *args, **kw, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 2
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        assert (got[0] == 0).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err < 2e-2, f"window {window}: {err}"
        assert _bites(ref, ctl), f"window {window}: the sinks do not move the plain version"
        for x, y in zip(mine, ref_p):
            assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("plan", [pa.DecodePlan(64, 3), pa.DecodePlan(64, 8),
                                  pa.DecodePlan(128, 2)])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_sinks_with_empty_splits(dev, hd, plan):
    """gpt-oss's sliding layers (window 128, group 8) at plans that leave
    splits past the walk: rows of kv_len 1, 100, 129, 256 (start 128: one
    or more splits exit) and 300; each head's sink enters once."""
    n_kv, group, bs, w, window = 8, 8, 64, 8, 128
    kv_lens = torch.tensor([1, 100, 129, 256, 300], device=dev, dtype=torch.int32)
    b = len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(7 + hd + plan.splits)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    s_total = (b * w + 1) * bs
    kp, vp = (torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((b, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    sinks = _sinks(g, n_kv * group, dev)
    pos = (kv_lens - 1).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    mine, ref_p = ([kp.clone(), vp.clone()] for _ in range(2))
    got = pa._decode_cuda(q, *mine, kn, vn, slots, bt, kv_lens, bs, 1 / math.sqrt(hd),
                          plan=plan, window=window, sinks=sinks)
    ref = paged_decode_attention_fused(q, *ref_p, kn, vn, slots, bt, kv_lens, block_size=bs,
                                       window=window, sinks=sinks, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_prefill_sinks_match_plain(dev, hd, group, bs):
    """A 150-token chunk on 4 rows: 150 valid on 200 past, none on 37, 77
    on 0, 131 on 64; several query tiles a row."""
    n_kv, t = 2, 150
    n_valid = torch.tensor([150, 0, 77, 131], device=dev, dtype=torch.int32)
    past = torch.tensor([200, 37, 0, 64], device=dev, dtype=torch.int32)
    kv_lens = n_valid + past
    b = len(n_valid)
    w = -(-(200 + t) // bs)
    g = torch.Generator(device=dev).manual_seed(3 * hd + group + bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    kp, vp = (torch.randn((n_kv, (b * w + 1) * bs, hd), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, t, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    sinks = _sinks(g, n_kv * group, dev)
    tok = torch.arange(t, device=dev)[None]
    p = past[:, None] + tok
    slots = (bt.gather(1, (p // bs).clamp_max(w - 1).long()) * bs + p % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    args = (kn, vn, slots, bt, kv_lens, n_valid)
    valid = tok < n_valid[:, None]
    name = _name("paged_prefill", hd)
    for window, softcap in OPTIONS:
        mine, again_p, ref_p, ctl_p = ([kp.clone(), vp.clone()] for _ in range(4))
        kw = dict(block_size=bs, window=window, softcap=softcap)
        reset_counts()
        got = paged_prefill_attention_fused(q, *mine, *args, **kw, sinks=sinks)
        again = paged_prefill_attention_fused(q, *again_p, *args, **kw, sinks=sinks)
        ref = paged_prefill_attention_fused(q, *ref_p, *args, **kw, sinks=sinks, plain=True)
        ctl = paged_prefill_attention_fused(q, *ctl_p, *args, **kw, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 2
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        err = (got.float() - ref.float())[valid].abs().max().item()
        assert err < 2e-2, f"window {window}: {err}"
        assert _bites(ref, ctl, valid), f"window {window}: the sinks do not move the plain version"
        for x, y in zip(mine, ref_p):
            assert torch.equal(x[:, :-1], y[:, :-1])


def _routing(g, ntok, e, top, dev):
    scores = torch.rand((ntok, e), generator=g, device=dev)
    topw, topi = torch.topk(scores, top, dim=-1)
    return torch.softmax(topw, dim=-1), topi


@pytest.mark.parametrize("ntok", [8, 512])
@pytest.mark.parametrize("n,k", [(5760, 2880), (2880, 2880), (272, 448)])
def test_dense_grouped_odd_k_matches_plain(dev, n, k, ntok):
    """Both bodies (8 tokens top-4: 16-row tiles; 512: 64-row tiles) at K
    an odd multiple of 64."""
    e, top = 32, 4
    g = torch.Generator(device=dev).manual_seed(n + k + ntok)
    w = (torch.randn((e, n, k), generator=g, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    topw, topi = _routing(g, ntok, e, top, dev)
    tm = grouped_tile(ntok * top)
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    x = torch.randn((ntok, k), generator=g, device=dev).to(torch.bfloat16)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = x[st]
    reset_counts()
    got = dense_matmul_grouped(xs, w, tiles, tm=tm, n_used_tiles=n_used)
    again = dense_matmul_grouped(xs, w, tiles, tm=tm, n_used_tiles=n_used)
    ref = dense_matmul_grouped(xs, w, tiles, tm=tm, n_used_tiles=n_used, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["dense_matmul_g"] == 2
    used = int(n_used)
    assert torch.equal(got, again) and bool((got[used * tm:] == 0).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("ntok", [8, 512])
def test_gpt_oss_expert_mlp_matches_plain(dev, ntok):
    """gpt-oss's expert MLP at its banks' widths (H = I = 2880, 8 experts of
    32 drawn) through the kernel and the plain version; inputs of std 3, so
    the clamp bites."""
    e, h, i, top = 8, 2880, 2880, 4
    g = torch.Generator(device=dev).manual_seed(ntok)

    def draw(*shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    ex = {"gateup": draw(e, 2 * i, h, std=h ** -0.5), "gateup_bias": draw(e, 2 * i, std=0.1),
          "down": draw(e, h, i, std=i ** -0.5), "down_bias": draw(e, h, std=0.1)}
    x = draw(ntok, h, std=3.0)
    topw, topi = _routing(g, ntok, e, top, dev)
    reset_counts()
    got = gpt_oss_grouped_mlp(x, ex, topw, topi)
    ref = gpt_oss_grouped_mlp(x, ex, topw, topi, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["dense_matmul_g"] == 2 and COUNTS["dense_matmul_g_plain"] == 2
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


def _gpt_oss_weights(cfg, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def draw(*shape, std=0.05, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    ones = torch.ones(h, device=dev, dtype=torch.bfloat16)
    layers = [{"attn_norm": ones.clone(), "ffn_norm": ones.clone(),
               "wqkv": draw(cfg.q_dim + 2 * cfg.kv_dim, h),
               "wqkv_bias": draw(cfg.q_dim + 2 * cfg.kv_dim, std=0.1),
               "wo": draw(h, cfg.q_dim), "wo_bias": draw(h, std=0.1),
               "sinks": draw(cfg.num_heads, std=1.0, dtype=torch.float32),
               "router": draw(e, h), "router_bias": draw(e, std=0.1),
               "experts": {"gateup": draw(e, 2 * i, h), "gateup_bias": draw(e, 2 * i, std=0.1),
                           "down": draw(e, h, i), "down_bias": draw(e, h, std=0.1)}}
              for _ in range(cfg.num_layers)]
    return {"embed": draw(cfg.vocab_size, h), "layers": layers, "final_norm": ones.clone(),
            "lm_head": draw(cfg.vocab_size, h)}


def test_gpt_oss_model_kernels_match_plain(dev, monkeypatch):
    """A 40-token prompt in chunks of 16 (past the window of 8), then 4
    decode steps: logits within 5e-2 of the largest. The plain run takes the
    kernel run's expert choices (near-tied router logits may pick others
    under another sum order), weighted from its own router logits."""
    cfg = ModelConfig(arch="gpt_oss", vocab_size=512, hidden_size=320, intermediate_size=192,
                      num_layers=2, num_heads=16, num_kv_heads=2, head_dim=64,
                      num_experts=8, num_experts_per_tok=4, sliding_window=8,
                      layer_types=["sliding_attention", "full_attention"], attention_bias=True,
                      rope_theta=150000.0,
                      rope_scaling={"rope_type": "yarn", "factor": 8.0, "beta_fast": 32.0,
                                    "beta_slow": 1.0, "truncate": False,
                                    "original_max_position_embeddings": 64},
                      max_position_embeddings=128)
    weights = _gpt_oss_weights(cfg, dev, 1)
    bs, n, n_dec = 16, 40, 4
    g = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (1, n + n_dec), generator=g, device=dev)
    bt = torch.arange(4, device=dev, dtype=torch.int32)[None]
    route, chosen = llama.route, []

    def recording_route(logits, cfg_):
        topw, topi = route(logits, cfg_)
        chosen.append(topi)
        return topw, topi

    def forced_route(logits, cfg_, forced=iter(chosen)):
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, next(forced), True)
        return route(logits.masked_fill(~keep, float("-inf")), cfg_)

    runs = []
    for plain in (False, True):
        monkeypatch.setattr(llama, "route", forced_route if plain else recording_route)
        cache = PagedKVCache.create(cfg, 4, bs, device=dev)
        outs = []
        reset_counts()
        for lo, hi in [(0, 16), (16, 32), (32, 40)] + [(n + d, n + d + 1) for d in range(n_dec)]:
            pos = torch.arange(lo, hi, device=dev)[None]
            logits, _ = forward_paged(weights, cfg, ids[:, lo:hi], pos, cache, bt,
                                      pos.to(torch.int32), torch.tensor([hi], device=dev),
                                      block_size=bs, plain=plain)
            outs.append(logits)
        torch.cuda.synchronize()
        if not plain:
            assert COUNTS["paged_prefill_hd64"] == 6 and COUNTS["paged_decode_hd64"] == 8
            assert COUNTS["dense_matmul_g"] == 2 * 2 * 7
            assert not any(v for k, v in COUNTS.items() if k.endswith("_plain"))
        runs.append(outs)
    for got, ref in zip(*runs):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
