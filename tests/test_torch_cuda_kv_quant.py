"""The quantized (int8 and fp8-e4m3) forms of the port's paged decode and
prefill kernels against their plain PyTorch versions on the card (marked
``cuda``; they skip where there is no GPU). On the card:

    python -m pytest tests/test_torch_cuda_kv_quant.py -q -m cuda --noconftest

Pools hold codes made by ``quantize_rows`` from random rows (one all-zero
row: code 0, scale 0) and their bf16 scales. The step's rows are quantized
by the kernel and by the plain version with the same f32 arithmetic (a true
division, half-to-even rounding for int8, a round-to-nearest-even cast for
e4m3), so the pools' codes and scales must be bit-equal, compared as bytes,
except at the trash slot, where the plain version parks dropped writes and
the kernels drop them. Outputs: within 2e-2 (bf16 outputs of magnitude ~1:
exp2 against exp, another sum order, P as two bf16 parts for the tensor
cores; the widened codes are exact in bf16), and a second call on the same
inputs bit-equal to the first (the decode kernel merges its splits in split
order).
"""

import pytest
import torch

from mistralrs_tpu_torch.kv.paged import CODE_DTYPES, quantize_rows
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    decode_plan,
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def quant_pools(g, n_kv, s_total, kv_quant, dev, hd=128):
    """K and V code pools [n_kv, S, hd] of random rows and their bf16 scale
    planes [n_kv, S]; slot 3 of head 0 holds an all-zero row."""
    out = []
    for _ in range(2):
        rows = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
        rows[0, 3] = 0
        codes, s = quantize_rows(rows, CODE_DTYPES[kv_quant])
        out += [codes, s.to(torch.bfloat16)]
    return out  # k, k_scale, v, v_scale


def same_bytes(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_pools(got, ref):
    """Pools and scale planes bit-equal but at the trash slot (the last)."""
    for a, b in zip(got, ref):
        assert same_bytes(a[:, :-1], b[:, :-1])


def decode_case(dev, kv_quant, group, bs, kv_lens, w, dropped=(), zero_row=None, seed=9,
                n_kv=8):
    """Quantized pools, tables of ``w`` blocks (wider than the rows'
    lengths), this step's bf16 rows and slots: each row writes its last
    position; the rows in ``dropped`` and those of kv_len 0 drop theirs, and
    row ``zero_row`` writes all-zero K and V rows."""
    hd, b = 128, len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(seed)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    pools = quant_pools(g, n_kv, (b * w + 1) * bs, kv_quant, dev)
    q = torch.randn((b, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    if zero_row is not None:
        kn[zero_row] = 0
        vn[zero_row] = 0
    kv_lens = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    for i in dropped:
        slots[i] = -1
    slots[kv_lens == 0] = -1
    return q, pools, (kn, vn, slots, bt, kv_lens)


def run_decode(q, pools, args, bs, plain=False):
    k, ks, v, vs = pools
    return paged_decode_attention_fused(q, k, v, *args, block_size=bs, k_scale=ks,
                                        v_scale=vs, plain=plain)


def check_decode(q, pools, args, bs, kv_quant):
    kv_lens = args[-1]
    mine = [t.clone() for t in pools]
    ref_pools = [t.clone() for t in pools]
    reset_counts()
    got = run_decode(q, mine, args, bs)
    again = run_decode(q, mine, args, bs)
    ref = run_decode(q, ref_pools, args, bs, plain=True)
    torch.cuda.synchronize()
    name = f"paged_decode_{kv_quant}"
    assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1 and COUNTS["paged_decode"] == 0
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got[kv_lens == 0] == 0).all()
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    check_pools(mine, ref_pools)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_decode_quantized_matches_plain(dev, group, bs, kv_quant):
    """The decode kernel's quantized forms at GQA groups 1-16 and blocks of
    16 and 64, on 1024-position tables (4 splits at B = 8): kv_len 0, one
    position, shorter than a split, on a split boundary, over every split, a
    dropped write (row 5), an all-zero step row (row 6) and a table wider
    than its kv_len (every row but the last)."""
    kv_lens = [0, 1, 100, 256, 512, 901, 1000, 1024]
    assert decode_plan(8, 8, group, 1024 // bs, bs) == (256, 4)
    q, pools, args = decode_case(dev, kv_quant, group, bs, kv_lens, 1024 // bs, dropped=(5,),
                                 zero_row=6)
    check_decode(q, pools, args, bs, kv_quant)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_decode_quantized_at_depth(dev, kv_quant):
    """Llama-3-8B's attention (32 query heads on 8 KV heads) at 8 x 4096
    positions, blocks of 64, one row dropping its write."""
    q, pools, args = decode_case(dev, kv_quant, 4, 64, [4096] * 8, 64, dropped=(7,))
    check_decode(q, pools, args, 64, kv_quant)


def prefill_case(dev, kv_quant, group, bs, t, n_valid, past, seed=3, n_kv=2):
    """Quantized pools, tables and a chunk of ``t`` tokens per row on top of
    ``past`` cached positions, ``n_valid`` of them real (the rest dropped
    writes); row 0's first token has all-zero K and V rows."""
    hd, b = 128, len(n_valid)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_valid = torch.tensor(n_valid, device=dev, dtype=torch.int32)
    kv_lens = n_valid + torch.tensor(past, device=dev, dtype=torch.int32)
    w = -(-(max(past) + t) // bs) + 1  # one block more than the longest row needs
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    pools = quant_pools(g, n_kv, (b * w + 1) * bs, kv_quant, dev)
    q = torch.randn((b, t, n_kv * group, hd), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    kn[0, 0] = 0
    vn[0, 0] = 0
    tok = torch.arange(t, device=dev)[None]
    pos = (kv_lens - n_valid)[:, None] + tok
    slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    return q, pools, (kn, vn, slots, bt, kv_lens, n_valid)


def check_prefill(q, pools, args, bs, kv_quant):
    n_valid = args[-1]
    mine = [t.clone() for t in pools]
    ref_pools = [t.clone() for t in pools]
    k, ks, v, vs = mine
    reset_counts()
    got = paged_prefill_attention_fused(q, k, v, *args, block_size=bs, k_scale=ks, v_scale=vs)
    k, ks, v, vs = ref_pools
    ref = paged_prefill_attention_fused(q, k, v, *args, block_size=bs, k_scale=ks, v_scale=vs,
                                        plain=True)
    torch.cuda.synchronize()
    name = f"paged_prefill_{kv_quant}"
    assert COUNTS[name] == 1 and COUNTS[name + "_plain"] == 1 and COUNTS["paged_prefill"] == 0
    assert torch.isfinite(got).all()
    for i, n in enumerate(n_valid.tolist()):
        if n:
            assert (got[i, :n].float() - ref[i, :n].float()).abs().max().item() < 2e-2
    check_pools(mine, ref_pools)
    # a second call on the pools as they were gives the same bits
    again_pools = [t.clone() for t in pools]
    k, ks, v, vs = again_pools
    again = paged_prefill_attention_fused(q, k, v, *args, block_size=bs, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for a, b in zip(again_pools, mine):
        assert same_bytes(a, b)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32, 64])
def test_prefill_quantized_matches_plain(dev, group, bs, kv_quant):
    """The prefill kernel's quantized forms at GQA groups 1-64 and blocks of
    16 and 64: a chunk spanning several query tiles, a row with n_valid 0,
    pasts not aligned to the 64-position tile (one of 0), tables one block
    wider than needed."""
    q, pools, args = prefill_case(dev, kv_quant, group, bs, 150, n_valid=[150, 0, 77, 131],
                                  past=[200, 37, 0, 64])
    check_prefill(q, pools, args, bs, kv_quant)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_prefill_quantized_at_engine_chunks(dev, kv_quant):
    """Llama-3-8B's attention (32/8 heads) at a 512-token chunk on 512 past
    positions and 2 x 128 tokens on 300, blocks of 64."""
    for t, n_valid, past in ((512, [512], [512]), (128, [128, 70], [300, 300])):
        q, pools, args = prefill_case(dev, kv_quant, 4, 64, t, n_valid, past, n_kv=8)
        check_prefill(q, pools, args, 64, kv_quant)
