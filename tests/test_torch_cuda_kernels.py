"""The port's CUDA kernels against their plain PyTorch versions on the card
(marked ``cuda``; they skip where there is no GPU). On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` sets up JAX and aiohttp for the JAX
package's tests, which these do not need.)

Tolerances: the decode body (W4 and W8 at row tiles of <= 16 rows) never
rounds the weight, applying scale and bias to f32 group sums; the W8
prefill body (more rows) rounds the dequantized weight exactly as the plain
version does and differs only in f32 sum order; the W4 prefill body rounds
it within an f32 ulp of the plain version's value (bf16 or f32 output: 1e-2
of the largest value). The attention kernels use exp2 with log2(e) folded into the scale
and another sum order, the prefill kernel carries P as two bf16 parts and
the MLA decode kernel rounds P to bf16 for their tensor-core products (bf16
output: atol 2e-2); the split-KV decode kernel carries P as two bf16 parts
too. The grouped (MoE) kernels share the matmul kernels' arithmetic and
tolerance, over every row including the zero rows of unused tiles; the
dense grouped kernel uses the bank's bf16 weights as they are (f32 sums in
another order: 1e-2 of the largest value). The split-KV decode kernel sums
its splits in split order, so two calls give the same bits, as they do for
the MLA decode kernel (the same in-order merge) and the dense grouped
kernel, whose blocks each own their outputs.
"""

import pytest
import torch

from mistralrs_tpu_torch.models import ModelConfig, fuse_projections
from mistralrs_tpu_torch.models.llama import forward_paged
from mistralrs_tpu_torch.kv.paged import PagedKVCache, gather_kv
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.mla_attention import mla_decode
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from mistralrs_tpu_torch.ops.moe_grouped import (
    build_groups,
    dense_grouped_plan,
    dense_matmul_grouped,
)
from mistralrs_tpu_torch.ops.paged_attention import decode_plan
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_grouped
from mistralrs_tpu_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qt(n, k, packed, gs, signed, dev, seed=0, bias=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if packed:
        data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    elif signed:
        data = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    else:
        data = torch.randint(0, 64, (k, n), generator=g, device=dev, dtype=torch.uint8)
    scale = torch.rand((k // gs, n), generator=g, device=dev) * 0.02
    bias = None if signed or not bias else -8 * scale
    return QTensor(data, scale, bias, group_size=gs, packed=packed,
                   code_bits=4 if packed else 8)


# (N, K): N a multiple of 64 or only of 16, K of one step (128), K = 4096 at
# N = 1024 (32 steps in splits that do not divide them), K = 14336
SHAPES = {"320x512": (320, 512), "336x128": (336, 128), "1024x4096": (1024, 4096),
          "4096x14336": (4096, 14336)}


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 130, 512])
@pytest.mark.parametrize("kind", ["w4", "w4_nobias", "w8_s32", "w8_s16", "w8_u32",
                                  "w8_s16_bias"])
def test_quant_matmul_kernel_matches_plain(dev, m, kind, shape, out):
    """Both W4 bodies and both W8 bodies (decode at M <= 16, prefill above:
    for W8 64-row tiles with K split at N = 1024 and at M = 512 N = 4096, and
    N = 336 not a multiple of 64) against their plain versions; W8 in its
    three byte formats (signed without bias at group 32 and 16, unsigned
    with bias, signed with bias)."""
    packed = kind.startswith("w4")
    gs = 16 if kind.startswith("w8_s16") else 32
    n, k = SHAPES[shape]
    qt = _qt(n, k, packed, gs, signed=kind.startswith("w8_s"), dev=dev,
             bias=kind != "w4_nobias")
    if kind == "w8_s16_bias":  # the widened form: signed codes with a bias plane
        qt = QTensor(qt.data, qt.scale, -8 * qt.scale, group_size=gs, packed=False,
                     code_bits=8)
    x = torch.randn((m, k), device=dev).to(torch.bfloat16)
    out_dtype = torch.float32 if out == "f32" else None
    reset_counts()
    got = quant_matmul(x, qt, out_dtype=out_dtype)
    ref = quant_matmul(x, qt, plain=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    name = "w4_matmul" if packed else "w8_matmul"
    assert COUNTS[name] == 1 and COUNTS[name + "_plain"] == 1
    assert got.dtype == (out_dtype or torch.bfloat16) and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


def _bank(e, n, k, kind, dev, seed=0):
    """A bank of ``kind``: "dense" bf16, "w4" / "w4_nobias" Q4_K-style, or a
    W8 byte format: "w8" (Q6_K-style: int8 in [-32, 32), group 16), "w8_bias"
    (the widened form: the same with a bias plane), "w8_s32" (Q8_0-style:
    int8 over all 256 values, group 32), "w8_u8_bias" (uint8 over all 256
    values, group 32, with a bias plane)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "dense":
        return (torch.randn((e, n, k), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    packed = kind.startswith("w4")
    gs = 16 if kind in ("w8", "w8_bias") else 32
    if packed:
        data = torch.randint(0, 256, (e, k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    elif kind == "w8_s32":
        data = torch.randint(-128, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    elif kind == "w8_u8_bias":
        data = torch.randint(0, 256, (e, k, n), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    else:
        data = torch.randint(-32, 32, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((e, k // gs, n), generator=g, device=dev) * 0.02
    bias = -8 * scale if kind in ("w4", "w8_bias", "w8_u8_bias") else None
    return QTensor(data, scale, bias, group_size=gs, packed=packed,
                   code_bits=4 if packed else 8)


@pytest.mark.parametrize("routing", ["ragged", "all_to_one", "empty_expert"])
@pytest.mark.parametrize("ntok", [8, 200])
@pytest.mark.parametrize("kind", ["w4", "w4_nobias", "w8", "w8_bias", "w8_s32", "w8_u8_bias",
                                  "dense"])
def test_grouped_kernels_match_plain(dev, kind, ntok, routing):
    """The W4, W8 and dense grouped kernels against their plain versions at
    the 16-row (decode) and 64-row (prefill) tiles, with the ragged,
    all-to-one and empty-expert routings; W8 in every byte format."""
    e, n, k = 8, 320, 512
    g = torch.Generator(device=dev).manual_seed(1)
    topi = torch.randint(0, e, (ntok, 2), generator=g, device=dev)
    if routing == "all_to_one":
        topi[:] = 5
    elif routing == "empty_expert":
        topi[topi == 2] = 3
    topw = torch.rand((ntok, 2), generator=g, device=dev)
    tm = 16 if ntok * 2 <= 256 else 64
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    x = torch.randn((ntok, k), generator=g, device=dev).to(torch.bfloat16)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = x[st]
    bank = _bank(e, n, k, kind, dev)
    fn = dense_matmul_grouped if kind == "dense" else quant_matmul_grouped
    reset_counts()
    got = fn(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
    ref = fn(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=True)
    torch.cuda.synchronize()
    name = {"w4": "w4_matmul_g", "w4_nobias": "w4_matmul_g",
            "dense": "dense_matmul_g"}.get(kind, "w8_matmul_g")
    assert COUNTS[name] == 1 and COUNTS[name + "_plain"] == 1
    assert torch.isfinite(got).all()
    assert (got[int(n_used) * tm:] == 0).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("kind", ["w4", "w8", "w8_u8_bias", "dense"])
@pytest.mark.parametrize("ntok", [8, 200])
def test_unused_tiles_come_out_zero(dev, kind, ntok):
    """Tiles at or past n_used are written as zeros, not left as whatever the
    output's memory held: the output is allocated where NaNs were just
    freed, at both row tiles, on a bank of 8 experts of which 3 are used."""
    e, n, k = 8, 320, 512
    g = torch.Generator(device=dev).manual_seed(2)
    topi = torch.randint(0, 3, (ntok, 2), generator=g, device=dev)
    topw = torch.rand((ntok, 2), generator=g, device=dev)
    tm = 16 if ntok * 2 <= 256 else 64
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    assert int(n_used) * tm < mp
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = torch.randn((ntok, k), generator=g, device=dev).to(torch.bfloat16)[st]
    bank = _bank(e, n, k, kind, dev)
    fn = dense_matmul_grouped if kind == "dense" else quant_matmul_grouped
    for _ in range(3):
        poison = torch.full((mp, n), float("nan"), device=dev, dtype=torch.bfloat16)
        del poison
        got = fn(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
        torch.cuda.synchronize()
        assert (got[int(n_used) * tm:] == 0).all()
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("m", [17, 130, 512])
@pytest.mark.parametrize("gs", [16, 32])
@pytest.mark.parametrize("signed", [False, True])
def test_w8_prefill_body_full_byte_range(dev, m, signed, gs):
    """The W8 prefill body at Mixtral's attn_v (N = 1024, K = 4096: K split
    so the grid fills the card) with codes over all 256 byte values and a
    bias plane: within 1e-2 of the plain version, and the same bits on a
    second call (the splits are summed in split order)."""
    n, k = 1024, 4096
    g = torch.Generator(device=dev).manual_seed(8)
    lo, dt = (-128, torch.int8) if signed else (0, torch.uint8)
    data = torch.randint(lo, lo + 256, (k, n), generator=g, device=dev, dtype=torch.int32).to(dt)
    scale = torch.rand((k // gs, n), generator=g, device=dev) * 0.01
    qt = QTensor(data, scale, -0.5 * scale, group_size=gs, packed=False, code_bits=8)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    reset_counts()
    got = quant_matmul(x, qt, out_dtype=torch.float32)
    again = quant_matmul(x, qt, out_dtype=torch.float32)
    ref = quant_matmul(x, qt, plain=True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert COUNTS["w8_matmul"] == 2
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def test_attention_kernels_match_plain(dev):
    n_kv, group, hd, bs, b = 2, 4, 128, 16, 3
    w = 6
    s = (b * w + 1) * bs
    bt = torch.randperm(b * w, device=dev, dtype=torch.int32).reshape(b, w)
    kp = torch.randn((n_kv, s, hd), device=dev).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    q = torch.randn((b, n_kv * group, hd), device=dev).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, hd), device=dev).to(torch.bfloat16)
    kv_lens = torch.tensor([37, 1, 90], device=dev, dtype=torch.int32)
    slots = (bt.gather(1, ((kv_lens - 1) // bs)[:, None].long())[:, 0] * bs
             + (kv_lens - 1) % bs).to(torch.int32)
    slots[1] = -1
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got = paged_decode_attention_fused(q, k1, v1, kn, kn, slots, bt, kv_lens, block_size=bs)
    ref = paged_decode_attention_fused(q, k2, v2, kn, kn, slots, bt, kv_lens,
                                       block_size=bs, plain=True)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    for pool_a, pool_b in ((k1, k2), (v1, v2)):
        ga, _ = gather_kv(pool_a, pool_a, bt, bs)
        gb, _ = gather_kv(pool_b, pool_b, bt, bs)
        for i, n in enumerate(kv_lens.tolist()):
            assert torch.equal(ga[i, :n], gb[i, :n])
    t = 40
    n_valid = torch.tensor([40, 17, 33], device=dev, dtype=torch.int32)
    kv_lens = n_valid + torch.tensor([30, 0, 50], device=dev, dtype=torch.int32)
    pos = (kv_lens - n_valid)[:, None] + torch.arange(t, device=dev)[None]
    slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
    slots[torch.arange(t, device=dev)[None] >= n_valid[:, None]] = -1
    qp = torch.randn((b, t, n_kv * group, hd), device=dev).to(torch.bfloat16)
    kpn = torch.randn((b, t, n_kv, hd), device=dev).to(torch.bfloat16)
    got = paged_prefill_attention_fused(qp, k1, v1, kpn, kpn, slots, bt, kv_lens, n_valid,
                                        block_size=bs)
    ref = paged_prefill_attention_fused(qp, k2, v2, kpn, kpn, slots, bt, kv_lens, n_valid,
                                        block_size=bs, plain=True)
    torch.cuda.synchronize()
    for i, n in enumerate(n_valid.tolist()):
        assert (got[i, :n].float() - ref[i, :n].float()).abs().max().item() < 2e-2
    ga, _ = gather_kv(k1, k1, bt, bs)
    gb, _ = gather_kv(k2, k2, bt, bs)
    for i, n in enumerate(kv_lens.tolist()):
        assert torch.equal(ga[i, :n], gb[i, :n])


@pytest.mark.parametrize("n", [1024, 4096, 4112])
@pytest.mark.parametrize("gs", [16, 32])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_w8_decode_body_full_byte_range(dev, m, signed, gs, n):
    """The W8 decode body with codes over all 256 byte values (unsigned
    0..255, signed -128..127), with bias, in 64-column blocks (N = 1024,
    Mixtral's attn_v: K split unevenly) and 128-column blocks (N = 4096; N =
    4112, the last block partly past N):
    within 1e-2 of the plain version, and the same bits on a second call
    (the splits are summed in split order)."""
    k = 4096
    g = torch.Generator(device=dev).manual_seed(7)
    lo, dt = (-128, torch.int8) if signed else (0, torch.uint8)
    data = torch.randint(lo, lo + 256, (k, n), generator=g, device=dev, dtype=torch.int32).to(dt)
    scale = torch.rand((k // gs, n), generator=g, device=dev) * 0.01
    qt = QTensor(data, scale, -0.5 * scale, group_size=gs, packed=False, code_bits=8)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got = quant_matmul(x, qt, out_dtype=torch.float32)
    again = quant_matmul(x, qt, out_dtype=torch.float32)
    ref = quant_matmul(x, qt, plain=True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def _prefill_case(dev, group, bs, t, n_valid, past, seed=3, n_kv=2):
    """Pools, tables and a chunk of ``t`` tokens per row on top of ``past``
    cached positions, ``n_valid`` of them real (the rest dropped writes)."""
    hd, b = 128, len(n_valid)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_valid = torch.tensor(n_valid, device=dev, dtype=torch.int32)
    kv_lens = n_valid + torch.tensor(past, device=dev, dtype=torch.int32)
    w = -(-(max(past) + t) // bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    s_total = (b * w + 1) * bs
    kp = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, t, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    tok = torch.arange(t, device=dev)[None]
    pos = (kv_lens - n_valid)[:, None] + tok
    slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    return q, kp, vp, (kn, vn, slots, bt, kv_lens, n_valid)


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_prefill_kernel_matches_plain(dev, group, bs):
    """The tensor-core prefill body at GQA groups 1-8 and blocks of 16 and
    64: a chunk spanning several query tiles, a row with n_valid 0, pasts
    not aligned to the 64-position tile (one of 0). Valid rows within 2e-2
    (bf16 output, another sum order), the pools bit-equal to the plain version's
    but the trash slot (the plain version parks dropped writes there)."""
    t = 150
    q, kp, vp, args = _prefill_case(dev, group, bs, t, n_valid=[150, 0, 77, 131],
                                    past=[200, 37, 0, 64])
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    reset_counts()
    got = paged_prefill_attention_fused(q, k1, v1, *args, block_size=bs)
    ref = paged_prefill_attention_fused(q, k2, v2, *args, block_size=bs, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["paged_prefill"] == 1 and COUNTS["paged_prefill_plain"] == 1
    assert torch.isfinite(got).all()
    for i, n in enumerate(args[-1].tolist()):
        if n:
            assert (got[i, :n].float() - ref[i, :n].float()).abs().max().item() < 2e-2
    assert torch.equal(k1[:, :-1], k2[:, :-1]) and torch.equal(v1[:, :-1], v2[:, :-1])


def test_prefill_kernel_at_engine_chunks(dev):
    """Llama-3-8B's attention (32/8 heads) at the engine's chunk shapes: four
    256-token prompts from position 0, and one 512-token chunk on 512 past
    positions, blocks of 64."""
    for t, n_valid, past in ((256, [256, 256, 200, 256], [0, 0, 0, 0]), (512, [512], [512])):
        q, kp, vp, args = _prefill_case(dev, 4, 64, t, n_valid, past, n_kv=8)
        k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        got = paged_prefill_attention_fused(q, k1, v1, *args, block_size=64)
        ref = paged_prefill_attention_fused(q, k2, v2, *args, block_size=64, plain=True)
        torch.cuda.synchronize()
        for i, n in enumerate(n_valid):
            assert (got[i, :n].float() - ref[i, :n].float()).abs().max().item() < 2e-2
        assert torch.equal(k1[:, :-1], k2[:, :-1]) and torch.equal(v1[:, :-1], v2[:, :-1])


def test_forward_paged_kernels_match_plain(dev):
    """Two Q4_K-style layers at head_dim 128: logits of a prefill and a
    decode step through the kernels against the plain path (rtol 5e-2 of the
    logit range: bf16 activations over two layers)."""
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128)
    layers = []
    for li in range(2):
        layers.append({
            "attn_norm": torch.ones(512, device=dev, dtype=torch.bfloat16),
            "ffn_norm": torch.ones(512, device=dev, dtype=torch.bfloat16),
            "wq": _qt(512, 512, True, 32, False, dev, 10 * li + 1),
            "wk": _qt(256, 512, True, 32, False, dev, 10 * li + 2),
            "wv": _qt(256, 512, True, 32, False, dev, 10 * li + 3),
            "wo": _qt(512, 512, True, 32, False, dev, 10 * li + 4),
            "gate": _qt(1024, 512, True, 32, False, dev, 10 * li + 5),
            "up": _qt(1024, 512, True, 32, False, dev, 10 * li + 6),
            "down": _qt(512, 1024, True, 32, False, dev, 10 * li + 7),
        })
    weights = fuse_projections({
        "embed": torch.randn((512, 512), device=dev).to(torch.bfloat16),
        "layers": layers,
        "final_norm": torch.ones(512, device=dev, dtype=torch.bfloat16),
        "lm_head": _qt(512, 512, False, 32, True, dev, 99),
    }, cfg)
    bs, t = 16, 24
    bt = torch.arange(8, device=dev, dtype=torch.int32).reshape(2, 4)
    ids = torch.randint(0, 512, (2, t), device=dev)
    pos = torch.arange(t, device=dev)[None].expand(2, t)
    slots = (bt.gather(1, (pos // bs).long()) * bs + pos % bs).to(torch.int32)
    outs = []
    for plain in (False, True):
        cache = PagedKVCache.create(cfg, 8, bs, device=dev)
        lp, _ = forward_paged(weights, cfg, ids, pos, cache, bt, slots,
                              torch.full((2,), t, device=dev), block_size=bs, plain=plain)
        ld, _ = forward_paged(weights, cfg, ids[:, :1], torch.full((2, 1), t, device=dev),
                              cache, bt, slots[:, :1] + t, torch.full((2,), t + 1, device=dev),
                              block_size=bs, plain=plain)
        outs.append((lp, ld))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        span = (b.max() - b.min()).item()
        assert (a - b).abs().max().item() <= 5e-2 * span


# (heads, row width D, rank, kv_lens, positions a table holds): DeepSeek-V2-
# Lite's head shapes with sequences of one split beside sequences of several;
# 20 heads (two head tiles, the second partial); one sequence at 8192
# positions (64 splits: eight merge groups); rank 576 = D (two column groups,
# the second of 64 columns); a row of 136 (not a multiple of 16) at rank 128
MLA_CASES = {
    "v2lite": (16, 576, 512, (1024, 0, 300, 1, 77), 1024),
    "heads20": (20, 576, 512, (1024, 0, 300, 1, 77), 1024),
    "b1_8192": (16, 576, 512, (8192,), 8192),
    "rank576": (16, 576, 576, (1024, 0, 300, 1, 77), 1024),
    "d136": (12, 136, 128, (1024, 0, 300, 1, 77), 1024),
}


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_decode_kernel_matches_plain(dev, case, bs):
    """The MLA decode kernel with a dropped write (when there are several
    rows: the kv_len-0 row's), a write into the last block of a table and a
    2-layer pool: output within 2e-2 (bf16, P rounded to bf16 for the tensor
    cores), the written layer exact except the trash row, the other layer
    untouched, kv_len 0 giving zeros, and two calls giving the same bits (the
    splits are merged in split order)."""
    nh, d, rank, lens, positions = MLA_CASES[case]
    b, w = len(lens), positions // bs
    g = torch.Generator(device=dev).manual_seed(4)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    pool = torch.randn((2, (b * w + 1) * bs, d), generator=g, device=dev).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    if b > 1:
        slots[1] = -1
    q = torch.randn((b, nh, d), generator=g, device=dev).to(torch.bfloat16)
    rows = torch.randn((b, d), generator=g, device=dev).to(torch.bfloat16)
    p1, p2 = pool.clone(), pool.clone()
    reset_counts()
    got = mla_decode(q, p1, rows, slots, bt, kv_lens, 0, rank=rank, block_size=bs, scale=0.07)
    again = mla_decode(q, p1, rows, slots, bt, kv_lens, 0, rank=rank, block_size=bs, scale=0.07)
    ref = mla_decode(q, p2, rows, slots, bt, kv_lens, 0, rank=rank, block_size=bs, scale=0.07,
                     plain=True)
    torch.cuda.synchronize()
    assert COUNTS["mla_decode"] == 2 and COUNTS["mla_decode_plain"] == 1
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    assert torch.equal(p1, p2) and torch.equal(p1[1], pool[1])
    if b > 1:
        assert (got[1] == 0).all()  # kv_len 0: zeros
        assert torch.equal(p1[0, -1], rows[1])  # the dropped write in the trash row


@pytest.mark.parametrize("ntok", [6, 192])
def test_dense_grouped_kernel_at_deepseek_shapes(dev, ntok):
    """The dense grouped kernel on DeepSeek-V2-Lite's expert banks (64
    experts, gate/up [64, 2816, 2048] and down [64, 2048, 1408]), top-6."""
    e, h, mi = 64, 2048, 1408
    g = torch.Generator(device=dev).manual_seed(5)
    topi = torch.rand((ntok, e), generator=g, device=dev).argsort(dim=1)[:, :6]
    topw = torch.rand((ntok, 6), generator=g, device=dev)
    tm = 16 if ntok * 6 <= 256 else 64
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    for n, k in ((2 * mi, h), (h, mi)):
        bank = (torch.randn((e, n, k), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
        x = torch.randn((ntok, k), generator=g, device=dev).to(torch.bfloat16)
        xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
        xs[dest] = x[st]
        got = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
        ref = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=True)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and (got[int(n_used) * tm:] == 0).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item()


def _decode_case(dev, group, bs, kv_lens, w, dropped=(), seed=9, n_kv=8):
    """Pools, tables, this step's rows and slots (each row writes its last
    position; the rows in ``dropped`` and those of kv_len 0 drop theirs)."""
    hd, b = 128, len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(seed)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    s_total = (b * w + 1) * bs
    kp = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    kv_lens = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    for i in dropped:
        slots[i] = -1
    slots[kv_lens == 0] = -1
    return q, kp, vp, (kn, vn, slots, bt, kv_lens)


def _check_decode(q, kp, vp, args, bs):
    """The decode kernel against the plain version: output within 2e-2,
    kv_len-0 rows zero, the pools exactly the old ones with the kept writes
    in place (a dropped write touches nothing), and a second call on the
    same inputs bit-equal to the first."""
    kn, vn, slots, bt, kv_lens = args
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    reset_counts()
    got = paged_decode_attention_fused(q, k1, v1, *args, block_size=bs)
    again = paged_decode_attention_fused(q, k1, v1, *args, block_size=bs)
    ref = paged_decode_attention_fused(q, k2, v2, *args, block_size=bs, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["paged_decode"] == 2 and COUNTS["paged_decode_plain"] == 1
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got[kv_lens == 0] == 0).all()
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    keep = slots >= 0
    for pool, new, old in ((k1, kn, kp), (v1, vn, vp)):
        want = old.clone()
        want[:, slots[keep].long()] = new[keep].transpose(0, 1)
        assert torch.equal(pool, want)


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
def test_decode_kernel_matches_plain(dev, group, bs):
    """The split-KV decode kernel at GQA groups 1-16 and blocks of 16 and
    64, on 1024-position tables (4 splits of 256 positions at B = 8): kv_len
    0, one position, shorter than a split, exactly on a split boundary, a
    row over every split, a dropped write (row 5: the pool's old row is read
    at its last position) and a full table."""
    kv_lens = [0, 1, 100, 256, 512, 901, 1000, 1024]
    plan = decode_plan(8, 8, group, 1024 // bs, bs)
    assert plan == (256, 4)
    q, kp, vp, args = _decode_case(dev, group, bs, kv_lens, 1024 // bs, dropped=(5,))
    _check_decode(q, kp, vp, args, bs)


@pytest.mark.parametrize("b,length", [(1, 8192), (8, 4096)])
def test_decode_kernel_at_depth(dev, b, length):
    """Llama-3-8B's attention (32 query heads on 8 KV heads) at depth: one
    request at 8192 positions (32 splits of 256) and 8 at 4096 each (6
    splits of 704), blocks of 64, one of them dropping its write."""
    w = length // 64
    q, kp, vp, args = _decode_case(dev, 4, 64, [length] * b, w, dropped=(b - 1,))
    _check_decode(q, kp, vp, args, 64)


def _dense_case(dev, ntok, routing, e=8, n=320, k=1408, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    topi = torch.randint(0, e, (ntok, 2), generator=g, device=dev)
    if routing == "all_to_one":
        topi[:] = e - 1
    elif routing == "empty_expert":
        topi[topi == 2] = 3
    tm = 16 if ntok * 2 <= 256 else 64
    st, dest, _, tiles, n_used, mp = build_groups(
        topi, torch.rand((ntok, 2), generator=g, device=dev), e, tm)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = torch.randn((ntok, k), generator=g, device=dev).to(torch.bfloat16)[st]
    bank = (torch.randn((e, n, k), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    return xs, bank, tiles, n_used, tm


@pytest.mark.parametrize("routing", ["ragged", "all_to_one", "empty_expert"])
@pytest.mark.parametrize("body", ["decode", "prefill"])
def test_dense_grouped_bodies_match_plain(dev, body, routing):
    """Each body of the dense grouped kernel on a bank of 8 experts
    [320, 1408] (N a multiple of 64 but not of 256; 22 steps of 64 k) at the
    three routings: within 1e-2 of the plain version, unused tiles zero (the
    output allocated over freed NaNs), a second call bit-equal."""
    xs, bank, tiles, n_used, tm = _dense_case(dev, 8 if body == "decode" else 200, routing)
    assert dense_grouped_plan(tm).body == body
    ref = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=True)
    outs = []
    for _ in range(2):
        poison = torch.full((xs.shape[0], bank.shape[1]), float("nan"), device=dev,
                            dtype=torch.bfloat16)
        del poison
        outs.append(dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used))
    torch.cuda.synchronize()
    got = outs[0]
    assert torch.isfinite(got).all() and torch.equal(got, outs[1])
    assert (got[int(n_used) * tm:] == 0).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("ntok,n,want", [(2, 320, ("decode", 64)), (8, 2048, ("decode", 64)),
                                         (8, 4096, ("decode", 64)),
                                         (200, 320, ("prefill", 256))])
def test_dense_grouped_plan_on_the_card(dev, ntok, n, want):
    """The wrapper's own plan on the card, at decode steps of 2 and 8
    tokens and a 200-token prefill chunk: the launch count, the plain
    version's result within 1e-2 and a second call bit-equal."""
    xs, bank, tiles, n_used, tm = _dense_case(dev, ntok, "ragged", n=n)
    assert dense_grouped_plan(tm) == want
    reset_counts()
    got = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
    again = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
    ref = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=True)
    torch.cuda.synchronize()
    assert COUNTS["dense_matmul_g"] == 2 and COUNTS["dense_matmul_g_plain"] == 1
    assert torch.equal(got, again) and (got[int(n_used) * tm:] == 0).all()
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
