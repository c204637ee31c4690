"""The GGUF slice's kernel forms on the card (marked ``cuda``; they skip
where there is no GPU), against their plain PyTorch versions:

    python -m pytest tests/test_torch_cuda_gguf.py -q -m cuda --noconftest

W4 at group 16 (Q2_K's 2-bit codes in nibbles, counted as
``w4_matmul_g16`` and ``w4_matmul_g16_g``) in both bodies, dense (M 1 to
512; N a multiple of 16 but not of 64; K of one step; K splits) and grouped
(16-row tiles: the decode body; 64-row tiles: the prefill body; routings
drawn, all to one expert, one expert empty), with and without a bias
plane, bf16 and f32 output; W8 with unsigned codes and a bias at group 32
(Q5_K, Q5_0, Q5_1) and Q3_K banks (signed, group 16). Every layer is drawn
as raw GGUF blocks on the card (``gguf/drawn.py``) and decoded there by the
port's planarizers, which must give the CPU's planes bit for bit. Then a
2-layer qwen3moe in a Q2_K mix read through ``load_gguf_model``: 8 decode
steps through the captured graph and through the step function eagerly
give bit-equal logits and the same tokens. Tolerances as
``tests/test_torch_cuda_kernels.py`` states them: 1e-2 of the largest
|output|; a second call gives the same bits; tiles past the used ones are
zero.
"""

import pytest
import torch

from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf import planar
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.drawn import (
    DrawnGGUF,
    draw_blocks,
    gguf_metadata,
    llama_family_tensors,
)
from mistralrs_tpu_torch.models import llama
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import build_groups, grouped_tile
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_grouped
from mistralrs_tpu_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda

TYPES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _layer(t, shape, dev, seed=0, bias=True):
    """A matrix or bank of type ``t`` drawn as raw blocks on the card and
    decoded there; ``bias=False`` drops its bias plane."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qt = QTensor.from_gguf_raw(draw_blocks(GGMLType[t], shape, gen, dev), GGMLType[t], shape,
                               device=dev)
    if not bias:
        qt = QTensor(qt.data, qt.scale, None, group_size=qt.group_size, packed=qt.packed,
                     code_bits=qt.code_bits)
    return qt


def _name(qt):
    if qt.packed:
        return "w4_matmul_g16" if qt.group_size == 16 else "w4_matmul"
    return "w8_matmul"


def _check_dense(qt, m, dev, out_dtype=None, seed=1):
    x = torch.randn((m, qt.in_features), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(torch.bfloat16)
    reset_counts()
    got = quant_matmul(x, qt, out_dtype=out_dtype)
    again = quant_matmul(x, qt, out_dtype=out_dtype)
    ref = quant_matmul(x, qt, plain=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    name = _name(qt)
    body = "decode" if m <= 16 else "prefill"
    assert (COUNTS[name], COUNTS[f"{name}.{body}"], COUNTS[name + "_plain"]) == (2, 2, 1)
    assert got.dtype == (out_dtype or torch.bfloat16) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


# (N, K): one step of K, N not a multiple of 64; a 1024-column matrix whose
# decode splits do not divide its steps; Qwen3-30B-A3B's attn_q and
# attn_output
SHAPES = {"336x128": (336, 128), "1024x4096": (1024, 4096), "4096x2048": (4096, 2048),
          "2048x4096": (2048, 4096)}


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 130, 512])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_w4_g16_matches_plain(dev, shape, m, bias, out):
    qt = _layer("Q2_K", SHAPES[shape], dev, bias=bias) if SHAPES[shape][1] % 256 == 0 else None
    if qt is None:  # K of one step (128) is not whole Q2_K super-blocks: planes drawn directly
        n, k = SHAPES[shape]
        g = torch.Generator(device=dev).manual_seed(2)
        data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        scale = (0.75 + 0.5 * torch.rand((k // 16, n), generator=g, device=dev)) / (1.25 * k) ** 0.5
        qt = QTensor(data & 0x33, scale, -1.5 * scale if bias else None, group_size=16,
                     packed=True, code_bits=2)
    assert qt.packed and qt.group_size == 16
    _check_dense(qt, m, dev, torch.float32 if out == "f32" else None)


@pytest.mark.parametrize("t", ["Q5_K", "Q5_0", "Q5_1", "Q4_0", "Q4_1"])
@pytest.mark.parametrize("m", [1, 8, 17, 512])
def test_other_types_match_plain(dev, t, m):
    """Q5_K/Q5_0/Q5_1 on W8 (unsigned codes, bias, group 32); Q4_0/Q4_1 on
    W4 at group 32 with a bias plane."""
    qt = _layer(t, (1024, 4096), dev, seed=3)
    assert qt.group_size == 32 and qt.bias is not None and qt.packed == t.startswith("Q4")
    _check_dense(qt, m, dev, torch.float32 if m == 17 else None)


def _routing(ntok, e, routing, gen, dev, top):
    topi = torch.rand((ntok, e), generator=gen, device=dev).argsort(dim=1)[:, :top]
    if routing == "all_to_one":
        topi[:] = e - 1
    elif routing == "empty_expert":
        topi[topi == 2] = 3
    return topi, torch.rand((ntok, top), generator=gen, device=dev)


def _check_grouped(bank, ntok, routing, dev, out_dtype=None, top=4):
    e, _, k = bank.shape
    gen = torch.Generator(device=dev).manual_seed(7)
    topi, topw = _routing(ntok, e, routing, gen, dev, top)
    tm = grouped_tile(ntok * top)
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    x = torch.randn((ntok, k), generator=gen, device=dev).to(torch.bfloat16)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = x[st]

    def run(plain=False):
        return quant_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used, plain=plain,
                                    out_dtype=out_dtype)

    reset_counts()
    got, again, ref = run(), run(), run(plain=True)
    torch.cuda.synchronize()
    name = _name(bank) + "_g"
    body = "decode" if tm == 16 else "prefill"
    assert (COUNTS[name], COUNTS[f"{name}.{body}"], COUNTS[name + "_plain"]) == (2, 2, 1)
    assert got.dtype == (out_dtype or torch.bfloat16) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert bool((got[int(n_used) * tm:] == 0).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("routing", ["random", "all_to_one", "empty_expert"])
@pytest.mark.parametrize("ntok", [8, 512], ids=["tile16_decode", "tile64_prefill"])
def test_w4_g16_grouped_matches_plain(dev, ntok, routing, bias, out):
    """A Q2_K bank of 16 experts at Qwen3-30B-A3B's gate/up K (2048)."""
    bank = _layer("Q2_K", (16, 384, 2048), dev, seed=4, bias=bias)
    assert bank.packed and bank.group_size == 16 and bank.num_banks == 16
    _check_grouped(bank, ntok, routing, dev, torch.float32 if out == "f32" else None)


@pytest.mark.parametrize("t", ["Q3_K", "Q5_K"])
@pytest.mark.parametrize("ntok", [8, 512], ids=["tile16_decode", "tile64_prefill"])
def test_w8_banks_match_plain(dev, t, ntok):
    """Q3_K (signed, group 16, no bias) at Qwen3-30B-A3B's down K (768) and
    Q5_K (unsigned, bias, group 32) banks on the W8 grouped kernel."""
    bank = _layer(t, (16, 512, 768), dev, seed=5)
    assert not bank.packed and bank.group_size == (16 if t == "Q3_K" else 32)
    _check_grouped(bank, ntok, "random", dev)


@pytest.mark.parametrize("t", TYPES)
def test_planarizers_on_the_card_match_the_cpu(dev, t):
    """Every type's decomposition on the card equals the CPU's bit for bit
    (codes, scales, biases), and so does a QTensor built from the bytes."""
    shape = (96, 1024)
    raw = draw_blocks(GGMLType[t], shape, torch.Generator(device=dev).manual_seed(6), dev)
    a, b = planar.to_planar(raw, GGMLType[t]), planar.to_planar(raw.cpu(), GGMLType[t])
    assert a.q.device.type == "cuda"
    for f in ("q", "scale", "bias"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x.cpu().view(torch.uint8) if x.dtype != torch.float32
                               else x.cpu().view(torch.int32),
                               y.view(torch.uint8) if y.dtype != torch.float32
                               else y.view(torch.int32))
    qa = QTensor.from_gguf_raw(raw, GGMLType[t], shape, device=dev)
    qb = QTensor.from_gguf_raw(raw.cpu(), GGMLType[t], shape, device="cpu")
    assert torch.equal(qa.data.cpu(), qb.data) and torch.equal(qa.scale.cpu(), qb.scale)


def _q2k_mix(stem, layer):
    """The tiny model's types: Q2_K attention q/k/o, gate/up banks and
    embedding; Q3_K attn_v and down banks; a Q6_K head."""
    if stem in ("attn_v", "ffn_down_exps"):
        return GGMLType.Q3_K
    return GGMLType.Q6_K if stem == "output" else GGMLType.Q2_K


def test_qwen3moe_q2k_graph_matches_eager(dev):
    """A 2-layer qwen3moe (hidden 256, 4/2 heads of 64, q/k norm, 16
    experts top-4 of 256) in a Q2_K mix drawn on the card and read through
    ``load_gguf_model``: 8 decode steps through the captured graph and
    eagerly give bit-equal logits and tokens; the graph launches W4 at
    group 16 dense and grouped, W8 grouped (Q3_K down) and no plain
    version."""
    cfg = ModelConfig(arch="qwen3moe", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64, qk_norm=True,
                      rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=512,
                      num_experts=16, num_experts_per_tok=4, moe_intermediate_size=256)
    content = DrawnGGUF(gguf_metadata(cfg), llama_family_tensors(cfg, _q2k_mix), dev, seed=3)
    lcfg, weights, _ = load_gguf_model(content, device=dev)
    assert (lcfg.arch, lcfg.qk_norm, lcfg.num_experts, lcfg.head_dim) == ("qwen3moe", True, 16, 64)
    weights = llama.fuse_projections(weights, lcfg)
    lw = weights["layers"][0]
    assert lw["experts"]["gateup"].group_size == 16 and lw["experts"]["gateup"].packed
    assert lw["experts"]["down"].signed and lw["wq"].packed and lw["q_norm"].shape == (64,)
    te = Engine(lcfg, weights, num_blocks=32, block_size=64, max_batch=4, prefill_chunk=32,
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
    assert counts["w4_matmul_g16_g.decode"] == counts["w8_matmul_g.decode"] == 8 * 2
    assert counts["w4_matmul_g16.decode"] > 0 and counts["paged_decode_hd64"] == 8 * 2
    assert not any(k.endswith("_plain") for k in counts)
    ds.close()
