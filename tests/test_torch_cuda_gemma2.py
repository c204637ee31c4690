"""The paged decode and prefill kernels' sliding windows, logit softcap and
head_dim 256 (Gemma-2) against their plain PyTorch versions on the card
(marked ``cuda``; they skip where there is no GPU). On the card:

    python -m pytest tests/test_torch_cuda_gemma2.py -q -m cuda --noconftest

Each kernel runs at head_dim 128 and 256, GQA groups 1, 2, 4 and 8, blocks
of 16 and 64, softcap 0 and 50, and windows 0 (none), 1, 64 and 192 (on a
tile edge), 100 and 700 (not): bf16 outputs within 2e-2 (exp2 against exp,
another sum order, P as two bf16 parts: the tolerance of
``tests/test_torch_cuda_kernels.py``), a second call bit-equal, the pools
bit-equal to the plain version's but at the trash slot, where the plain
version parks dropped writes. Decode covers kv_len 0, one position, a
dropped write and rows on and off tile and split edges; prefill a row with
n_valid 0, pasts not a multiple of the block and chunks that straddle the
window's edge. A 2-layer Gemma-2 (head_dim 256, window 8) runs through the
kernels and the plain versions: logits within 5e-2 of the largest.
"""

import pytest
import torch

from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import forward_paged, init_random_weights
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

pytestmark = pytest.mark.cuda

WINDOWS = (0, 1, 64, 100, 192, 700)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _name(kernel, hd):
    return f"{kernel}_hd256" if hd == 256 else kernel


def _pools(g, n_kv, s_total, hd, dev):
    return [torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2)]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [128, 256])
def test_decode_window_softcap_matches_plain(dev, hd, group, bs, softcap):
    """B = 8 on 1024-position tables: kv_len 0 (its write dropped), 1, 63,
    64, 65, 700 (its write dropped), 1000 and 1024. With a softcap the
    queries are 4x larger, so that it bites."""
    n_kv, w = 2, 1024 // bs
    kv_lens = torch.tensor([0, 1, 63, 64, 65, 700, 1000, 1024], device=dev, dtype=torch.int32)
    b = len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(hd + group + bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    s_total = (b * w + 1) * bs
    kp, vp = _pools(g, n_kv, s_total, hd, dev)
    q = (torch.randn((b, n_kv * group, hd), generator=g, device=dev)
         * (4.0 if softcap else 1.0)).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    slots[0] = slots[5] = -1
    name = _name("paged_decode", hd)
    for window in WINDOWS:
        mine = [kp.clone(), vp.clone()]
        ref_p = [kp.clone(), vp.clone()]
        args = (kn, vn, slots, bt, kv_lens)
        kw = dict(block_size=bs, window=window, softcap=softcap)
        reset_counts()
        got = paged_decode_attention_fused(q, *mine, *args, **kw)
        again = paged_decode_attention_fused(q, *mine, *args, **kw)
        ref = paged_decode_attention_fused(q, *ref_p, *args, **kw, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        assert (got[0] == 0).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err < 2e-2, f"window {window}: {err}"
        for x, y in zip(mine, ref_p):
            assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [128, 256])
def test_prefill_window_softcap_matches_plain(dev, hd, group, bs, softcap):
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
    kp, vp = _pools(g, n_kv, (b * w + 1) * bs, hd, dev)
    q = (torch.randn((b, t, n_kv * group, hd), generator=g, device=dev)
         * (4.0 if softcap else 1.0)).to(torch.bfloat16)
    kn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    tok = torch.arange(t, device=dev)[None]
    pos = past[:, None] + tok
    slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    args = (kn, vn, slots, bt, kv_lens, n_valid)
    name = _name("paged_prefill", hd)
    for window in WINDOWS:
        mine, again_p, ref_p = ([kp.clone(), vp.clone()] for _ in range(3))
        kw = dict(block_size=bs, window=window, softcap=softcap)
        reset_counts()
        got = paged_prefill_attention_fused(q, *mine, *args, **kw)
        again = paged_prefill_attention_fused(q, *again_p, *args, **kw)
        ref = paged_prefill_attention_fused(q, *ref_p, *args, **kw, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        for i, n in enumerate(n_valid.tolist()):
            if n:
                err = (got[i, :n].float() - ref[i, :n].float()).abs().max().item()
                assert err < 2e-2, f"window {window} row {i}: {err}"
        for x, y in zip(mine, ref_p):
            assert torch.equal(x[:, :-1], y[:, :-1])


def test_gemma2_model_kernels_match_plain(dev):
    """2 layers (one sliding, window 8; one full) at head_dim 256, both
    softcaps: a 40-token prompt in chunks of 16, then 4 decode steps."""
    cfg = ModelConfig(arch="gemma2", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=256,
                      sliding_window=8, attn_logit_softcap=50.0, logit_softcap=30.0,
                      attn_scale=256 ** -0.5, rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
                      max_position_embeddings=128)
    weights = init_random_weights(cfg, seed=1, device=dev)
    bs, n, n_dec = 16, 40, 4
    g = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (1, n + n_dec), generator=g, device=dev)
    bt = torch.arange(4, device=dev, dtype=torch.int32)[None]
    runs = []
    for plain in (False, True):
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
            assert COUNTS["paged_prefill_hd256"] == 6 and COUNTS["paged_decode_hd256"] == 8
            assert not any(v for k, v in COUNTS.items() if k.endswith("_plain"))
        runs.append(outs)
    for got, ref in zip(*runs):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
