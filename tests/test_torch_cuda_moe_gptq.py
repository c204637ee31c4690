"""The W4 and W8 grouped kernels' wide-group forms on the card (marked
``cuda``; they skip where there is no GPU), against their plain PyTorch
versions, and a tiny qwen2moe GPTQ model through the captured decode step:

    python -m pytest tests/test_torch_cuda_moe_gptq.py -q -m cuda --noconftest

Banks of 8 experts at groups 64 and 128 (W4: split-half packed, K/2 a
multiple of the group; W8: unsigned and signed codes) and per-column (W8,
g = K), in both bodies: 16-row tiles take the decode body, 64-row tiles
the prefill body (W8: pairs of one expert's tiles a block). Routings drawn
from a generator, every choice on the last expert, and one expert left
empty; bf16 and f32 output. Tolerances as
``tests/test_torch_cuda_kernels.py`` states them: 1e-2 of the largest
|output|; a second call gives the same bits; tiles past the used ones are
zero. Then a 2-layer qwen2moe drawn as its GPTQ-Int4 checkpoint stores it
(int32 words and f16 scales on the card, decoded by the HF loader): 8 decode
steps through the captured graph and through the step function eagerly
give bit-equal logits and the same tokens, and the graph launches both
grouped wide forms and no plain version.
"""

import math

import pytest
import torch

from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models import hf_loader, llama
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import build_groups, grouped_tile
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul_grouped
from mistralrs_tpu_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bank(e, n, k, gs, fmt, dev, seed=0):
    """A bank of ``e`` experts: "w4" split-half packed nibbles, "u8"
    unsigned bytes over all 256 values, "s8" signed bytes; scales of
    weights of variance ~1/K and a bias plane centring the codes (as GPTQ
    and AWQ layers decode)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if fmt == "w4":
        data = torch.randint(0, 256, (e, k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        mid, var = 7.5, 21.25
    else:
        lo, dt = (0, torch.uint8) if fmt == "u8" else (-128, torch.int8)
        data = torch.randint(lo, lo + 256, (e, k, n), generator=g, device=dev,
                             dtype=torch.int32).to(dt)
        mid, var = (127.5 if fmt == "u8" else -0.5), 5461.25
    scale = (0.75 + 0.5 * torch.rand((e, k // gs, n), generator=g, device=dev)) / (var * k) ** 0.5
    return QTensor(data, scale, -mid * scale, group_size=gs, packed=fmt == "w4",
                   code_bits=4 if fmt == "w4" else 8)


# kind: (format, group, K): Qwen1.5-MoE's gate/up K (2048) for W4, its down
# K (1408 = 11 x 128) for W8, per-column there as g = K
KINDS = {"w4_g64": ("w4", 64, 2048), "w4_g128": ("w4", 128, 2048),
         "u8_g64": ("u8", 64, 1408), "u8_g128": ("u8", 128, 1408),
         "s8_g128": ("s8", 128, 1408), "u8_gK": ("u8", 1408, 1408)}


def _routing(ntok, e, routing, gen, dev, top=4):
    topi = torch.rand((ntok, e), generator=gen, device=dev).argsort(dim=1)[:, :top]
    if routing == "all_to_one":
        topi[:] = e - 1
    elif routing == "empty_expert":
        topi[topi == 2] = 3
    return topi, torch.rand((ntok, top), generator=gen, device=dev)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("routing", ["random", "all_to_one", "empty_expert"])
@pytest.mark.parametrize("ntok", [8, 512], ids=["tile16_decode", "tile64_prefill"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_grouped_wide_match_plain(dev, kind, ntok, routing, out):
    fmt, gs, k = KINDS[kind]
    e, n = 8, 384
    bank = _bank(e, n, k, gs, fmt, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    topi, topw = _routing(ntok, e, routing, gen, dev)
    tm = grouped_tile(ntok * 4)
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    x = torch.randn((ntok, k), generator=gen, device=dev).to(torch.bfloat16)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = x[st]
    out_dtype = torch.float32 if out == "f32" else None

    def run(plain=False):
        return quant_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=plain,
                                    out_dtype=out_dtype)

    reset_counts()
    got, again, ref = run(), run(), run(plain=True)
    torch.cuda.synchronize()
    name = ("w4_matmul" if fmt == "w4" else "w8_matmul") + "_wide_g"
    body = "decode" if tm == 16 else "prefill"
    assert (COUNTS[name], COUNTS[f"{name}.{body}"], COUNTS[name + "_plain"]) == (2, 2, 1)
    assert got.dtype == (out_dtype or torch.bfloat16) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    used = int(n_used)
    assert bool((got[used * tm:] == 0).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


def _words(n, k, gen, dev, group=128):
    """One projection ``[n, k]`` as a symmetric GPTQ 4-bit checkpoint stores
    it (zeros 7, read with v1's + 1), drawn on the card."""
    words = torch.randint(-2**31, 2**31, (k // 8, n), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    zero = sum(7 << (4 * i) for i in range(8))  # 0x77777777
    scales = ((0.75 + 0.5 * torch.rand((k // group, n), generator=gen, device=dev))
              / math.sqrt(21.5 * k)).to(torch.float16)
    return {"qweight": words, "qzeros": torch.full((k // group, n // 8), zero, dtype=torch.int32,
                                                   device=dev),
            "scales": scales, "g_idx": torch.arange(k, dtype=torch.int32, device=dev) // group}


def test_qwen2moe_gptq_graph_matches_eager(dev):
    """A 2-layer qwen2moe (hidden 256, 4/4 heads of 64, 8 experts top-4 of
    384, a shared expert of 512) as GPTQ-Int4 stores it: the experts' gate
    and up land on W4 grouped at group 128, their down (K = 384, K/2 % 128
    = 64) on W8 grouped with unsigned codes and a bias, attention and the
    shared expert on W4; the router and the shared-expert gate stay f16."""
    cfg = ModelConfig(arch="qwen2moe", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=4, head_dim=64, rms_norm_eps=1e-6,
                      rope_theta=1e6, max_position_embeddings=512, num_experts=8,
                      num_experts_per_tok=4, moe_intermediate_size=384,
                      shared_expert_intermediate_size=512)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, e, mi, si = 256, 8, 384, 512

    def f16(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float16).mul_(std)

    sd = {"model.embed_tokens.weight": f16(512, h), "model.norm.weight": f16(h, std=0).add_(1),
          "lm_head.weight": f16(512, h)}
    for li in range(2):
        p = f"model.layers.{li}."
        projs = {f"self_attn.{t}_proj": (256, 256) for t in "qkvo"}
        for j in range(e):
            projs.update({f"mlp.experts.{j}.gate_proj": (mi, h),
                          f"mlp.experts.{j}.up_proj": (mi, h),
                          f"mlp.experts.{j}.down_proj": (h, mi)})
        projs.update({"mlp.shared_expert.gate_proj": (si, h), "mlp.shared_expert.up_proj": (si, h),
                      "mlp.shared_expert.down_proj": (h, si)})
        for name, (n, k) in projs.items():
            for part, t in _words(n, k, gen, dev).items():
                sd[f"{p}{name}.{part}"] = t
        for t in "qkv":
            sd[f"{p}self_attn.{t}_proj.bias"] = f16(256, std=0.1)
        sd[p + "input_layernorm.weight"] = f16(h, std=0).add_(1)
        sd[p + "post_attention_layernorm.weight"] = f16(h, std=0).add_(1)
        sd[p + "mlp.gate.weight"] = f16(e, h, std=0.5)
        sd[p + "mlp.shared_expert_gate.weight"] = f16(1, h, std=0.3)
    qc = {"quant_method": "gptq", "bits": 4, "group_size": 128, "sym": True, "desc_act": False}
    weights = llama.fuse_projections(hf_loader.weights_from_state_dict(
        sd, cfg, device=dev, quant_config=qc), cfg)
    ex = weights["layers"][0]["experts"]
    assert ex["gateup"].packed and not ex["down"].packed and ex["down"].bias is not None
    te = Engine(cfg, weights, num_blocks=32, block_size=64, max_batch=4, prefill_chunk=32,
                device=dev)
    seqs = [te.add_request([(5 * i + j) % 500 + 1 for j in range(20 + 9 * i)],
                           SamplingParams(temperature=0.0 if i % 2 else 0.8, seed=i,
                                          max_tokens=64)) for i in range(3)]
    while any(len(s.output_ids) < 2 for s in seqs):
        te.step()
    ds, width = te.decode_step, te._max_blocks_bucket()
    assert width in ds._graphs
    c = te.cache
    saved = ([t.clone() for t in (c.k, c.v)],
             {k: getattr(te.samp_state, k).clone() for k in te.samp_state._ROWS})
    runs = []
    for mode in ("eager", "graph"):
        for t, s in zip((c.k, c.v), saved[0]):
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
    assert counts["w4_matmul_wide_g.decode"] == counts["w8_matmul_wide_g.decode"] == 8 * 2
    assert counts["w4_matmul_wide"] > 0 and counts["paged_decode_hd64"] == 8 * 2
    assert not any(k.endswith("_plain") for k in counts)
    ds.close()
