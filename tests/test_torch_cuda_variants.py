"""The paged decode and prefill kernels at head_dim 80 and 96 (Phi-2,
Phi-3-mini), and tiny models of the Llama-family variants through the
kernels, against their plain PyTorch versions on the card (marked ``cuda``;
they skip where there is no GPU). On the card:

    python -m pytest tests/test_torch_cuda_variants.py -q -m cuda --noconftest

Each form (bf16, int8 and fp8-e4m3 pools) runs at GQA groups 1, 4, 9 and
16 (prefill also 64), blocks of 16 and 64, without an option, with a
window (one on a tile edge, one off it), with a softcap and with sinks.
Decode: B = 8 on 1024-position tables, kv_len 0 (its write dropped), 1,
63, 64, 65, 700 (its write dropped), 1000 and 1024. Prefill: a 150-token
chunk on 4 rows (150 valid on 200 past, none on 37, 77 on 0, 131 on 64).
The checks of ``tests/test_torch_cuda_gemma2.py``: outputs within 2e-2 of
the plain version's (exp2 against exp, another sum order, P as two bf16
parts), a second call bit-equal, the pools (codes and scales) bit-equal
but at the trash slot, where the plain version parks dropped writes;
kv_len 0 gives zeros.

Then one tiny model per arch of the variants (phi2, phi3, starcoder2,
stablelm, cohere, granite, glm, glm4, smollm3, hunyuan) runs a prompt in
chunks and 4 decode steps through the kernels and through the plain
versions: logits within 5e-2 of the largest, no plain version in the
kernel run.
"""

import pytest
import torch

from mistralrs_tpu_torch.kv.paged import CODE_DTYPES, PagedKVCache, quantize_rows
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import (
    forward_paged,
    fuse_projections,
    init_random_weights,
)
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

pytestmark = pytest.mark.cuda

OPTIONS = ("window", "softcap", "sinks")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _name(kernel, kv_quant, hd):
    return f"{kernel}{'_' + kv_quant if kv_quant else ''}_hd{hd}"


def _pools(g, n_kv, s_total, hd, kv_quant, dev):
    """[k, k_scale, v, v_scale]: bf16 pools of random rows (scales None), or
    code pools of them with their bf16 scales (slot 3 of head 0 an all-zero
    row)."""
    out = []
    for _ in range(2):
        rows = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
        if kv_quant is None:
            out += [rows, None]
            continue
        rows[0, 3] = 0
        codes, s = quantize_rows(rows, CODE_DTYPES[kv_quant])
        out += [codes, s.to(torch.bfloat16)]
    return out


def _options(option, window, n_q, g, dev):
    if option == "window":
        return dict(window=window)
    if option == "softcap":
        return dict(softcap=20.0)
    return dict(sinks=torch.randn(n_q, generator=g, device=dev).add_(3.0))


def _same(got, ref):
    for a, b in zip(got, ref):
        if a is not None:
            assert torch.equal(a[:, :-1].contiguous().view(torch.uint8),
                               b[:, :-1].contiguous().view(torch.uint8))


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 4, 9, 16])
@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("hd", [80, 96])
def test_decode_hd80_96_matches_plain(dev, hd, kv_quant, group, bs):
    n_kv, w = 2, 1024 // bs
    kv_lens = torch.tensor([0, 1, 63, 64, 65, 700, 1000, 1024], device=dev, dtype=torch.int32)
    b = len(kv_lens)
    g = torch.Generator(device=dev).manual_seed(hd + group + bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    pools = _pools(g, n_kv, (b * w + 1) * bs, hd, kv_quant, dev)
    q = (torch.randn((b, n_kv * group, hd), generator=g, device=dev) * 3).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    pos = (kv_lens - 1).clamp_min(0).long()
    slots = (bt.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs).to(torch.int32)
    slots[0] = slots[5] = -1
    name = _name("paged_decode", kv_quant, hd)
    cases = [("none", {})] + [(f"{o} {wd}", _options(o, wd, n_kv * group, g, dev))
                              for o in OPTIONS for wd in ((100, 192) if o == "window" else (0,))]
    for what, opts in cases:
        mine, ref_p = ([None if t is None else t.clone() for t in pools] for _ in range(2))

        def run(p, plain=False):
            return paged_decode_attention_fused(q, p[0], p[2], kn, vn, slots, bt, kv_lens,
                                                block_size=bs, k_scale=p[1], v_scale=p[3],
                                                plain=plain, **opts)

        reset_counts()
        got, again, ref = run(mine), run(mine), run(ref_p, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), what
        assert (got[0] == 0).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err < 2e-2, f"{what}: {err}"
        _same(mine, ref_p)


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 4, 9, 16, 64])
@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("hd", [80, 96])
def test_prefill_hd80_96_matches_plain(dev, hd, kv_quant, group, bs):
    n_kv, t = 2, 150
    n_valid = torch.tensor([150, 0, 77, 131], device=dev, dtype=torch.int32)
    past = torch.tensor([200, 37, 0, 64], device=dev, dtype=torch.int32)
    kv_lens = n_valid + past
    b = len(n_valid)
    w = -(-(200 + t) // bs)
    g = torch.Generator(device=dev).manual_seed(3 * hd + group + bs)
    bt = torch.randperm(b * w, generator=g, device=dev).to(torch.int32).reshape(b, w)
    pools = _pools(g, n_kv, (b * w + 1) * bs, hd, kv_quant, dev)
    q = (torch.randn((b, t, n_kv * group, hd), generator=g, device=dev) * 3).to(torch.bfloat16)
    kn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, t, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    tok = torch.arange(t, device=dev)[None]
    pos = past[:, None] + tok
    slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    name = _name("paged_prefill", kv_quant, hd)
    cases = [("none", {})] + [(f"{o} {wd}", _options(o, wd, n_kv * group, g, dev))
                              for o in OPTIONS for wd in ((64, 100) if o == "window" else (0,))]
    for what, opts in cases:
        mine, again_p, ref_p = ([None if x is None else x.clone() for x in pools]
                                for _ in range(3))

        def run(p, plain=False):
            return paged_prefill_attention_fused(q, p[0], p[2], kn, vn, slots, bt, kv_lens,
                                                 n_valid, block_size=bs, k_scale=p[1],
                                                 v_scale=p[3], plain=plain, **opts)

        reset_counts()
        got, again, ref = run(mine), run(again_p), run(ref_p, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), what
        for i, n in enumerate(n_valid.tolist()):
            if n:
                err = (got[i, :n].float() - ref[i, :n].float()).abs().max().item()
                assert err < 2e-2, f"{what} row {i}: {err}"
        _same(mine, ref_p)


# the tiny models: each arch's features at a head dim the kernels take
TINY = {
    "phi2": dict(hidden_size=320, num_heads=4, num_kv_heads=4, head_dim=80,
                 norm_type="layernorm", partial_rotary_factor=0.4, parallel_residual=True,
                 hidden_act="gelu_new"),
    "phi3": dict(hidden_size=384, num_heads=4, num_kv_heads=4, head_dim=96, sliding_window=24),
    "starcoder2": dict(hidden_size=576, num_heads=9, num_kv_heads=1, head_dim=64,
                       norm_type="layernorm", hidden_act="gelu_pytorch_tanh", sliding_window=24),
    "stablelm": dict(hidden_size=256, num_heads=4, num_kv_heads=4, head_dim=64,
                     norm_type="layernorm", partial_rotary_factor=0.25),
    "cohere": dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   norm_type="layernorm", rope_interleaved=True, parallel_residual=True,
                   logits_scaling=8.0, tie_word_embeddings=True),
    "granite": dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
                    embedding_multiplier=12.0, residual_multiplier=0.22, attn_scale=0.0078125,
                    logits_scaling=16.0, tie_word_embeddings=True),
    "glm": dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
                partial_rotary_factor=0.5, rope_interleaved=True),
    "glm4": dict(hidden_size=256, num_heads=16, num_kv_heads=1, head_dim=64,
                 partial_rotary_factor=0.5, rope_interleaved=True),
    "smollm3": dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
                    no_rope_layers=[1, 0], tie_word_embeddings=True),
    "hunyuan": dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64, qk_norm=True,
                    qk_norm_after_rope=True),
}


def _variant(kind, dev):
    """A 2-layer model of ``kind``: ``init_random_weights`` with the arch's
    own leaves added (LayerNorm, q/k/v, o and MLP biases, a gateless MLP,
    glm4's post norms, hunyuan's q/k norms of 1 + N(0, 0.1^2), phi2's head
    bias)."""
    cfg = ModelConfig(arch=kind, vocab_size=512, intermediate_size=256, num_layers=2,
                      max_position_embeddings=256, **TINY[kind])
    w = init_random_weights(cfg, seed=len(kind), device=dev)
    g = torch.Generator(device=dev).manual_seed(len(kind))

    def draw(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev).mul_(std).to(torch.bfloat16)

    h = cfg.hidden_size
    for lw in w["layers"]:
        if kind in ("phi2", "starcoder2", "stablelm"):
            lw["attn_norm_bias"], lw["ffn_norm_bias"] = draw(h), draw(h)
        if kind in ("phi2", "starcoder2", "stablelm", "glm", "glm4"):
            for key, n in (("wq_bias", cfg.q_dim), ("wk_bias", cfg.kv_dim),
                           ("wv_bias", cfg.kv_dim)):
                lw[key] = draw(n, std=0.1)
        if kind in ("phi2", "starcoder2"):
            del lw["gate"]
            lw["up_bias"], lw["down_bias"], lw["wo_bias"] = draw(256), draw(h), draw(h)
        if cfg.parallel_residual:
            del lw["ffn_norm"]
        if kind == "glm4":
            lw["post_attn_norm"], lw["post_ffn_norm"] = draw(h).add_(1), draw(h).add_(1)
        if kind == "hunyuan":
            lw["q_norm"] = draw(cfg.head_dim, std=0.1).add_(1)
            lw["k_norm"] = draw(cfg.head_dim, std=0.1).add_(1)
    if kind in ("phi2", "starcoder2", "stablelm"):
        w["final_norm_bias"] = draw(h)
    if kind == "phi2":
        w["lm_head_bias"] = draw(cfg.vocab_size)
    return cfg, fuse_projections(w, cfg)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("kind", list(TINY))
def test_variant_model_kernels_match_plain(dev, kind, kv_quant):
    """A 40-token prompt in chunks of 16 (past the 24-position windows), then
    4 decode steps, through the kernels and the plain versions."""
    cfg, weights = _variant(kind, dev)
    bs, n, n_dec = 16, 40, 4
    g = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (1, n + n_dec), generator=g, device=dev)
    bt = torch.arange(4, device=dev, dtype=torch.int32)[None]
    runs = []
    for plain in (False, True):
        cache = PagedKVCache.create(cfg, 4, bs, kv_quant=kv_quant, device=dev)
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
            hd = cfg.head_dim
            assert COUNTS[_name("paged_prefill", kv_quant, hd).replace("_hd128", "")] == 6
            assert COUNTS[_name("paged_decode", kv_quant, hd).replace("_hd128", "")] == 8
            assert not any(v for k, v in COUNTS.items() if k.endswith("_plain"))
        runs.append(outs)
    for got, ref in zip(*runs):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
