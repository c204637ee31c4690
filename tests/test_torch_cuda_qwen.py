"""The Qwen family's kernel shapes on the card (marked ``cuda``; they skip
where there is no GPU), each against its plain PyTorch version. On the card:

    python -m pytest tests/test_torch_cuda_qwen.py -q -m cuda --noconftest

* The prefill kernel at every GQA group from 1 to 16, and at 20, 32 and 64,
  in its bf16, int8 and fp8 forms at head_dim 128: a query tile holds
  64 // group tokens, so a group that does not divide 64 leaves dead rows.
  A 150-token chunk on 4 rows (150 valid on 200 past, none on 37, 77 on 0,
  131 on 64): T is not a multiple of the tile's tokens at any group but 1,
  2 and 64 (qtok 64, 32, 1), and three rows have n_valid < T. bf16 outputs
  of the valid rows within 2e-2 (the tolerance of
  ``tests/test_torch_cuda_kernels.py``: exp2 against exp, another sum
  order, P as two bf16 parts), a second call bit-equal, the pools bit-equal
  but at the trash slot (as bytes, with the scale planes, for 1-byte pools).
* Groups 5 and 7 at head_dim 64 and 256 (bf16), plain and with a window of
  100, a softcap of 30 and sinks (N(4, 1) per head), the same checks.
* The decode kernel at groups 3, 5 and 7, bf16 and int8 (2e-2, bit-equal
  second call, pools equal).
* The dense grouped kernel on Qwen3-30B-A3B's banks (128 experts, top-8:
  gate/up N = 1536 K = 2048, down N = 2048 K = 768) at n*k = 48 (6 decode
  tokens, 16-row tiles) and 2048 (a 256-token chunk, 64-row tiles): within
  1e-2 of the largest |value| (f32 sums in another order), a second call
  bit-equal, unused tiles zero.
* A 2-layer Qwen2.5-style model (14 query heads on 2 KV heads: group 7,
  head_dim 128, q/k/v biases fused with ``fuse_projections``) and a 2-layer
  Qwen3-MoE-style model (8 query heads on 1 KV head, q_dim 1024 against a
  hidden 256, q/k norm, 128 experts top-8 renormalised) through the kernels
  and the plain versions: a 40-token prompt in 20-token chunks, then 4
  decode steps; logits within 5e-2 of the largest, the MoE plain run on the
  kernel run's expert choices (near-tied router logits may pick others
  under another sum order).
"""

import math

import pytest
import torch

from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models import llama
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import build_groups, dense_matmul_grouped, grouped_tile
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

from test_torch_cuda_kv_quant import check_decode, check_prefill, decode_case, prefill_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _name(kernel, hd):
    return f"{kernel}_hd{hd}" if hd in (64, 256) else kernel


def _bf16_prefill(dev, group, hd, window=0, softcap=0.0, sinks=False, n_kv=2, bs=16):
    """The bf16 prefill kernel on the 4-row, 150-token chunk of the module
    docstring against its plain version."""
    t = 150
    n_valid = torch.tensor([150, 0, 77, 131], device=dev, dtype=torch.int32)
    past = torch.tensor([200, 37, 0, 64], device=dev, dtype=torch.int32)
    kv_lens = n_valid + past
    b = len(n_valid)
    w = -(-(200 + t) // bs)
    g = torch.Generator(device=dev).manual_seed(11 * group + hd)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    kp, vp = (torch.randn((n_kv, (b * w + 1) * bs, hd), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, t, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    sk = torch.randn(n_kv * group, generator=g, device=dev).add_(4.0) if sinks else None
    tok = torch.arange(t, device=dev)[None]
    p = past[:, None] + tok
    slots = (bt.gather(1, (p // bs).clamp_max(w - 1).long()) * bs + p % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    args = (kn, vn, slots, bt, kv_lens, n_valid)
    kw = dict(block_size=bs, window=window, softcap=softcap, sinks=sk)
    mine, again_p, ref_p = ([kp.clone(), vp.clone()] for _ in range(3))
    name = _name("paged_prefill", hd)
    reset_counts()
    got = paged_prefill_attention_fused(q, *mine, *args, **kw)
    again = paged_prefill_attention_fused(q, *again_p, *args, **kw)
    ref = paged_prefill_attention_fused(q, *ref_p, *args, **kw, plain=True)
    torch.cuda.synchronize()
    assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
    valid = tok < n_valid[:, None]
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err = (got.float() - ref.float())[valid].abs().max().item()
    assert err < 2e-2, f"group {group} hd {hd} window {window}: {err}"
    for x, y in zip(mine, ref_p):
        assert torch.equal(x[:, :-1], y[:, :-1])


GROUPS = list(range(1, 17)) + [20, 32, 64]


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("group", GROUPS)
def test_prefill_every_group_matches_plain(dev, group, kv_quant):
    if kv_quant is None:
        _bf16_prefill(dev, group, 128)
    else:
        q, pools, args = prefill_case(dev, kv_quant, group, 16, 150, n_valid=[150, 0, 77, 131],
                                      past=[200, 37, 0, 64], seed=group)
        check_prefill(q, pools, args, 16, kv_quant)


@pytest.mark.parametrize("options", [(0, 0.0, False), (100, 30.0, True)],
                         ids=["plain", "window_softcap_sinks"])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("group", [5, 7])
def test_prefill_groups_5_and_7_other_head_dims(dev, group, hd, options):
    window, softcap, sinks = options
    _bf16_prefill(dev, group, hd, window=window, softcap=softcap, sinks=sinks, bs=64)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("group", [3, 5, 7])
def test_decode_groups_3_5_7_match_plain(dev, group, kv_quant):
    """B = 8 on 1024-position tables (4 splits): kv_len 0, 1, 100, 256, 512,
    901 (its write dropped), 1000 and 1024."""
    kv_lens = [0, 1, 100, 256, 512, 901, 1000, 1024]
    bs = 64
    if kv_quant is not None:
        q, pools, args = decode_case(dev, kv_quant, group, bs, kv_lens, 1024 // bs,
                                     dropped=(5,), seed=group)
        check_decode(q, pools, args, bs, kv_quant)
        return
    n_kv, hd, w = 4, 128, 1024 // bs
    b = len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(group)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    kp, vp = (torch.randn((n_kv, (b * w + 1) * bs, hd), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    pos = (lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    slots[0] = slots[5] = -1
    args = (kn, vn, slots, bt, lens)
    mine, ref_p = ([kp.clone(), vp.clone()] for _ in range(2))
    reset_counts()
    got = paged_decode_attention_fused(q, *mine, *args, block_size=bs)
    again = paged_decode_attention_fused(q, *mine, *args, block_size=bs)
    ref = paged_decode_attention_fused(q, *ref_p, *args, block_size=bs, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["paged_decode"] == 2 and COUNTS["paged_decode_plain"] == 1
    assert torch.isfinite(got).all() and torch.equal(got, again) and (got[0] == 0).all()
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    for x, y in zip(mine, ref_p):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("ntok", [6, 256])
@pytest.mark.parametrize("n,k", [(1536, 2048), (2048, 768)], ids=["gateup", "down"])
def test_dense_grouped_at_128_experts(dev, n, k, ntok):
    e, top = 128, 8
    g = torch.Generator(device=dev).manual_seed(n + ntok)
    w = (torch.randn((e, n, k), generator=g, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    topw, topi = torch.topk(torch.rand((ntok, e), generator=g, device=dev), top, dim=-1)
    tm = grouped_tile(ntok * top)
    assert tm == (16 if ntok == 6 else 64)
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


def _weights(cfg, dev, seed):
    """bf16 weights of N(0, 0.05^2), biases N(0, 0.1^2) where the config is
    Qwen2's, q/k norms 1 + N(0, 0.1^2), norms of ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.hidden_size

    def draw(*shape, std=0.05):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    ones = torch.ones(h, device=dev, dtype=torch.bfloat16)
    layers = []
    for _ in range(cfg.num_layers):
        lw = {"attn_norm": ones.clone(), "ffn_norm": ones.clone(), "wq": draw(cfg.q_dim, h),
              "wk": draw(cfg.kv_dim, h), "wv": draw(cfg.kv_dim, h), "wo": draw(h, cfg.q_dim)}
        if cfg.arch == "qwen2":
            lw.update(wq_bias=draw(cfg.q_dim, std=0.1), wk_bias=draw(cfg.kv_dim, std=0.1),
                      wv_bias=draw(cfg.kv_dim, std=0.1))
        else:
            lw.update(q_norm=1 + draw(cfg.head_dim, std=0.1),
                      k_norm=1 + draw(cfg.head_dim, std=0.1))
        if cfg.num_experts:
            e, mi = cfg.num_experts, cfg.moe_intermediate_size
            lw.update(router=draw(e, h, std=0.1),
                      experts={"gateup": draw(e, 2 * mi, h), "down": draw(e, h, mi)})
        else:
            i = cfg.intermediate_size
            lw.update(gate=draw(i, h), up=draw(i, h), down=draw(h, i))
        layers.append(lw)
    return fuse_projections({"embed": draw(cfg.vocab_size, h), "layers": layers,
                             "final_norm": ones.clone(), "lm_head": draw(cfg.vocab_size, h)}, cfg)


MODELS = {
    "qwen2.5": dict(arch="qwen2", vocab_size=512, hidden_size=512, intermediate_size=1024,
                    num_layers=2, num_heads=14, num_kv_heads=2, head_dim=128, rope_theta=1e6,
                    sliding_window=131072, rms_norm_eps=1e-6, max_position_embeddings=256),
    "qwen3moe": dict(arch="qwen3moe", vocab_size=512, hidden_size=256, intermediate_size=512,
                     num_layers=2, num_heads=8, num_kv_heads=1, head_dim=128, rope_theta=1e6,
                     qk_norm=True, num_experts=128, num_experts_per_tok=8,
                     moe_intermediate_size=128, norm_topk_prob=True, rms_norm_eps=1e-6,
                     max_position_embeddings=256),
}


@pytest.mark.parametrize("kind", list(MODELS))
def test_model_kernels_match_plain(dev, monkeypatch, kind):
    cfg = ModelConfig(**MODELS[kind])
    weights = _weights(cfg, dev, 1)
    assert ("wqkv_bias" in weights["layers"][0]) == (kind == "qwen2.5")
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
        for lo, hi in [(0, 20), (20, 40)] + [(n + d, n + d + 1) for d in range(n_dec)]:
            pos = torch.arange(lo, hi, device=dev)[None]
            logits, _ = forward_paged(weights, cfg, ids[:, lo:hi], pos, cache, bt,
                                      pos.to(torch.int32), torch.tensor([hi], device=dev),
                                      block_size=bs, plain=plain)
            outs.append(logits)
        torch.cuda.synchronize()
        if not plain:
            assert COUNTS["paged_prefill"] == 2 * 2 and COUNTS["paged_decode"] == 2 * n_dec
            assert COUNTS["dense_matmul_g"] == (2 * 2 * 6 if cfg.num_experts else 0)
            assert not any(v for k, v in COUNTS.items() if k.endswith("_plain"))
        runs.append(outs)
    for got, ref in zip(*runs):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
