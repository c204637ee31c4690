"""The quantized (int8 and fp8-e4m3) forms of the paged decode and prefill
kernels with sliding windows, logit softcaps, attention sinks and head_dim
64, 128 and 256, and a Gemma-3 engine over int8 pools, against their plain
PyTorch versions on the card (marked ``cuda``; they skip where there is no
GPU). On the card:

    python -m pytest tests/test_torch_cuda_gemma3.py -q -m cuda --noconftest

Each form runs at GQA groups 2 and 8 (Gemma's and gpt-oss's), blocks of 16
and 64, with each option alone and all together. Decode: B = 8 on
1024-position tables, kv_len 0 (its write dropped), 1, 63, 64, 65, 700 (its
write dropped), 1000 and 1024, windows 100 (off a tile edge) and 192 (on
one). Prefill: a 150-token chunk on 4 rows (150 valid on 200 past, none on
37, 77 on 0, 131 on 64), windows 64 and 100. The checks of
``tests/test_torch_cuda_kv_quant.py``: outputs within 2e-2 of the plain
version's, a second call bit-equal, the pools' codes and scales bit-equal
but at the trash slot; kv_len 0 gives zeros.

The Gemma-3 engine (6 layers, 5 sliding with a window of 16, head_dim 256,
q/k norms, linear rope scaling and a local base) serves 3 requests from
int8 pools past their windows; from one saved state, 8 decode steps through
the captured graph and 8 through the step function give bit-equal logits
and the same tokens, the graph's launches all of the quantized head_dim-256
decode form.
"""

import pytest
import torch

from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import CODE_DTYPES, quantize_rows
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import init_random_weights
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

pytestmark = pytest.mark.cuda

OPTIONS = ("window", "softcap", "sinks", "all")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _name(kernel, kv_quant, hd):
    return f"{kernel}_{kv_quant}" + (f"_hd{hd}" if hd in (64, 256) else "")


def _pools(g, n_kv, s_total, hd, kv_quant, dev):
    """Code pools of random rows and their bf16 scales (slot 3 of head 0 an
    all-zero row) → [k, k_scale, v, v_scale]."""
    out = []
    for _ in range(2):
        rows = torch.randn((n_kv, s_total, hd), generator=g, device=dev).to(torch.bfloat16)
        rows[0, 3] = 0
        codes, s = quantize_rows(rows, CODE_DTYPES[kv_quant])
        out += [codes, s.to(torch.bfloat16)]
    return out


def _options(option, window, n_q, g, dev):
    sinks = torch.randn(n_q, generator=g, device=dev).add_(3.0)
    return {"window": dict(window=window), "softcap": dict(softcap=20.0),
            "sinks": dict(sinks=sinks),
            "all": dict(window=window, softcap=20.0, sinks=sinks)}[option]


def _same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a[:, :-1].contiguous().view(torch.uint8),
                           b[:, :-1].contiguous().view(torch.uint8))


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [2, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_decode_quantized_options_match_plain(dev, kv_quant, hd, group, bs, option):
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
    for window in (100, 192):
        opts = _options(option, window, n_kv * group, g, dev)
        mine, ref_p = ([t.clone() for t in pools] for _ in range(2))

        def run(p, plain=False):
            return paged_decode_attention_fused(q, p[0], p[2], kn, vn, slots, bt, kv_lens,
                                                block_size=bs, k_scale=p[1], v_scale=p[3],
                                                plain=plain, **opts)

        reset_counts()
        got, again, ref = run(mine), run(mine), run(ref_p, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        assert (got[0] == 0).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err < 2e-2, f"window {window}: {err}"
        _same(mine, ref_p)
        if option in ("softcap", "sinks"):
            break  # the window plays no part


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [2, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_prefill_quantized_options_match_plain(dev, kv_quant, hd, group, bs, option):
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
    for window in (64, 100):
        opts = _options(option, window, n_kv * group, g, dev)
        mine, again_p, ref_p = ([x.clone() for x in pools] for _ in range(3))

        def run(p, plain=False):
            return paged_prefill_attention_fused(q, p[0], p[2], kn, vn, slots, bt, kv_lens,
                                                 n_valid, block_size=bs, k_scale=p[1],
                                                 v_scale=p[3], plain=plain, **opts)

        reset_counts()
        got, again, ref = run(mine), run(again_p), run(ref_p, plain=True)
        torch.cuda.synchronize()
        assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
        assert torch.isfinite(got).all() and torch.equal(got, again), f"window {window}"
        for i, n in enumerate(n_valid.tolist()):
            if n:
                err = (got[i, :n].float() - ref[i, :n].float()).abs().max().item()
                assert err < 2e-2, f"window {window} row {i}: {err}"
        _same(mine, ref_p)
        if option in ("softcap", "sinks"):
            break


def test_gemma3_engine_int8_graph_matches_eager(dev):
    cfg = ModelConfig(arch="gemma3", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=6, num_heads=4, num_kv_heads=2, head_dim=256,
                      sliding_window=16, attn_scale=256 ** -0.5, rms_norm_eps=1e-6,
                      rope_theta=1e6, rope_local_theta=1e4, qk_norm=True,
                      rope_scaling={"rope_type": "linear", "factor": 8.0},
                      hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
                      max_position_embeddings=256)
    weights = init_random_weights(cfg, seed=1, device=dev)
    te = Engine(cfg, weights, num_blocks=32, block_size=64, max_batch=4, prefill_chunk=32,
                kv_quant="int8", device=dev)
    assert te.cache.quantized
    seqs = [te.add_request([(5 * i + j) % 500 + 1 for j in range(20 + 9 * i)],
                           SamplingParams(temperature=0.0 if i % 2 else 0.8, seed=i,
                                          max_tokens=64)) for i in range(3)]
    while any(len(s.output_ids) < 2 for s in seqs):
        te.step()
    ds, width = te.decode_step, te._max_blocks_bucket()
    assert width in ds._graphs
    c = te.cache
    saved = ([t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)],
             {k: getattr(te.samp_state, k).clone() for k in te.samp_state._ROWS})
    runs = []
    for mode in ("eager", "graph"):
        for t, s in zip((c.k, c.v, c.k_scale, c.v_scale), saved[0]):
            t.copy_(s)
        for k, t in saved[1].items():
            getattr(te.samp_state, k).copy_(t)
        toks = {s.slot: s.all_ids[-1] for s in seqs}
        logits, tokens = [], []
        _cuda.reset_counts()
        for i in range(8):
            stage = ds.staging(width)
            for s in seqs:
                pos = s.total_len - 1 + i
                table = te.kv.block_table(s.request_id)
                stage[s.slot, :4] = (toks[s.slot], pos, table[pos // 64] * 64 + pos % 64,
                                     pos + 1)
                stage[s.slot, 4:4 + len(table)] = table
            if mode == "eager":
                ds.upload(width)
                out = ds.compute(width)
            else:
                ds.launch(width)
                out = ds.graph_output(width)
            torch.cuda.synchronize()
            logits.append(out.logits.clone())
            tokens.append(out.tokens.tolist())
            toks = {s.slot: tokens[-1][s.slot] for s in seqs}
        runs.append((logits, tokens, dict(_cuda.COUNTS)))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert runs[0][1] == runs[1][1]
    counts = runs[1][2]
    assert counts["paged_decode_int8_hd256"] == 8 * 6
    assert not any(k.endswith("_plain") for k in counts)
    ds.close()
