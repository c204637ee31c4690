"""GPTQ and AWQ checkpoints in the port, on the CPU, held against the JAX
package on inputs drawn with numpy from a seed.

* Decode: ``quant/gptq_awq.py``'s planes bit-equal to JAX
  ``gptq_to_qtensor``/``awq_to_qtensor`` (packing, codes, f32 scales, the
  f32 ``bias = -s * (z + offset)``), and ``dequantize()`` equal to the JAX
  reference dequants, over GPTQ at 4 and 8 bits, groups 32, 64, 128 and K,
  zero offsets 0 (``gptq_v2``) and 1 (v1), and AWQ at the same groups;
  every case holds words with bit 31 set (torch's ``>>`` on int32 is
  arithmetic; JAX reads the words as uint32).
* The plain matmul at groups 64, 128 and K against JAX
  ``quant_matmul(backend="xla")`` (f32 sums in another order: 1e-5 of the
  largest output), and one small case each of the W4 and W8 Pallas kernels
  at group 128 in interpret mode (1e-2 of the largest: the JAX W4 kernel
  adds the bias outside the bf16 weight).
* The kernel wrappers' group-size rules (``_check_planes``, which the
  plain versions do not need), and the split state an engine reserves
  against what the wrappers take at the wide groups (on meta tensors, with
  a fake kernel library).
* Tiny HF directories written with the port's safetensors writer: Llama
  GPTQ 4-bit at group 128 (hidden 256, so K/2 % 128 == 0: the W4 layout),
  Qwen2 GPTQ 8-bit at group 128 with q/k/v biases (the W8 layout, unsigned
  codes with a bias plane; ``fuse_projections`` fuses the planar q/k/v and
  their biases), Llama AWQ at group 128. Both loaders give equal weights,
  f32 ``forward_paged`` logits at every prefill chunk and decode step
  agree with JAX's (``backend="xla"``) within 5e-3 of the largest (both
  packages round x and the weight to bf16 for a quantized product, so an
  f32 sum-order difference that moves an activation across a bf16 rounding
  edge moves the logits by a bf16 ulp's share: 1.8e-3 at most here), and
  one engine's greedy tokens equal the JAX engine's.
* Refusals: act-order ``g_idx``, 3 bits, AWQ ``version: "gemv"``, a
  quantized ``lm_head``, GPTQ on an MoE config; and the W4 kernel's refusal
  of a group of 96.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.ops.quant_matmul import quant_matmul as jax_qmm
from mistralrs_tpu.quant import gptq_awq as jax_ga
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine, decode_widths, forward_rows
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models import llama as tll
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant import gptq_awq
from mistralrs_tpu_torch.quant.qtensor import QTensor

from test_torch_decode_step import _matmul_call, _recorded_split_state
from test_torch_deepseek import write_safetensors
from test_torch_llama import jax_to_numpy
from test_torch_qwen import _steps

AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def pack_rows(q, bits):
    """[K, N] codes → int32 [K / (32 / bits), N] (GPTQ's packing along K)."""
    per = 32 // bits
    out = np.zeros((q.shape[0] // per, q.shape[1]), np.uint32)
    for i in range(per):
        out |= q[i::per].astype(np.uint32) << (i * bits)
    return out.view(np.int32)


def pack_cols(codes, bits, awq):
    """[R, N] codes → int32 [R, N / (32 / bits)] (packing along N; AWQ's
    4-bit words interleaved)."""
    per = 32 // bits
    out = np.zeros((codes.shape[0], codes.shape[1] // per), np.uint32)
    for i in range(per):
        col = AWQ_ORDER[i] if awq and bits == 4 else i
        out |= codes[:, col::per].astype(np.uint32) << (i * bits)
    return out.view(np.int32)


def draw_layer(rng, k, n, group, bits, awq=False, sym=False, std=0.1):
    """One layer as a checkpoint stores it: (qweight, qzeros, scales f16),
    codes uniform over every value (so words have bit 31 set), zeros random
    (or GPTQ's symmetric 2^(bits-1) - 1 with ``sym``), scales giving weights
    of about ``std``."""
    g = k // group
    q = rng.integers(0, 1 << bits, (k, n)).astype(np.uint8)
    top = (1 << bits) - 1
    z = (np.full((g, n), (1 << (bits - 1)) - 1, np.uint8) if sym
         else rng.integers(0, top, (g, n)).astype(np.uint8))
    s = (std / np.sqrt(top * (top + 2) / 12) * (0.75 + 0.5 * rng.random((g, n)))).astype(
        np.float16)
    qweight = pack_cols(q, bits, awq=True) if awq else pack_rows(q, bits)
    return qweight, pack_cols(z, bits, awq), s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes_equal(tq, jq):
    assert (tq.packed, tq.group_size, tq.code_bits, tq.shape) == (
        jq.packed, jq.group_size, jq.code_bits, jq.shape)
    for name in ("data", "scale", "bias"):
        a, b = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


K, N = 256, 64
GROUPS = [32, 64, 128, K]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("group", GROUPS, ids=["g32", "g64", "g128", "gK"])
@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_planes_bit_equal_to_jax(bits, group, offset):
    qw, qz, s = draw_layer(np.random.default_rng(bits + group + offset), K, N, group, bits)
    assert (qw < 0).any()  # words with bit 31 set
    tq = gptq_awq.gptq_to_qtensor(_t(qw), _t(qz), _t(s), bits=bits, zero_offset=offset)
    jq = jax_ga.gptq_to_qtensor(qw, qz, s, bits=bits, zero_offset=offset)
    _planes_equal(tq, jq)
    assert tq.packed == (bits == 4 and group != K)
    ref = jax_ga.dequant_gptq_reference(qw, qz, s, bits=bits, zero_offset=offset)
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    np.testing.assert_array_equal(
        gptq_awq.dequant_gptq_reference(_t(qw), _t(qz), _t(s), bits, offset).numpy(), ref)
    np.testing.assert_allclose(tq.dequantize().numpy(), ref.T, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("group", GROUPS, ids=["g32", "g64", "g128", "gK"])
def test_awq_planes_bit_equal_to_jax(group):
    qw, qz, s = draw_layer(np.random.default_rng(group), K, N, group, 4, awq=True)
    assert (qw < 0).any()
    tq = gptq_awq.awq_to_qtensor(_t(qw), _t(qz), _t(s))
    jq = jax_ga.awq_to_qtensor(qw, qz, s)
    _planes_equal(tq, jq)
    ref = jax_ga.dequant_awq_reference(qw, qz, s)
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    np.testing.assert_array_equal(
        gptq_awq.dequant_awq_reference(_t(qw), _t(qz), _t(s)).numpy(), ref)


MATMUL_CASES = {"w4_g64": (4, 64, False), "w4_g128": (4, 128, False), "w8_gK_4bit": (4, K, False),
                "w8_g128": (8, 128, False), "w8_gK": (8, K, False), "awq_g128": (4, 128, True)}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_plain_matmul_matches_xla(case):
    """f32 dequant and f32 inputs: the plain version against JAX's XLA path
    (1e-5 of the largest output), counted under the wide-group name."""
    bits, group, awq = MATMUL_CASES[case]
    qw, qz, s = draw_layer(np.random.default_rng(3), K, N, group, bits, awq=awq)
    if awq:
        tq, jq = gptq_awq.awq_to_qtensor(_t(qw), _t(qz), _t(s)), jax_ga.awq_to_qtensor(qw, qz, s)
    else:
        tq = gptq_awq.gptq_to_qtensor(_t(qw), _t(qz), _t(s), bits=bits)
        jq = jax_ga.gptq_to_qtensor(qw, qz, s, bits=bits)
    x = np.random.default_rng(4).standard_normal((5, K)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x), jq, backend="xla", dequant_dtype=jnp.float32))
    reset_counts()
    got = qm.quant_matmul(_t(x), tq, compute_dtype=torch.float32).numpy()
    name = ("w4_matmul" if tq.packed else "w8_matmul") + "_wide_plain"
    assert COUNTS[name] == 1 and sum(COUNTS.values()) == 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bits", [4, 8], ids=["w4", "w8"])
def test_plain_matmul_matches_pallas_interpret_group128(bits):
    """The JAX W4 / W8 Pallas kernels at group 128 in interpret mode on a
    tiny GPTQ layer (bf16; 1e-2 of the largest output)."""
    k, n = 512, 128
    qw, qz, s = draw_layer(np.random.default_rng(5 + bits), k, n, 128, bits)
    tq = gptq_awq.gptq_to_qtensor(_t(qw), _t(qz), _t(s), bits=bits)
    jq = jax_ga.gptq_to_qtensor(qw, qz, s, bits=bits)
    assert tq.packed == (bits == 4) and tq.group_size == 128
    x = np.random.default_rng(6).standard_normal((4, k)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), jq, backend="pallas",
                             interpret=True), np.float32)
    got = qm.quant_matmul(_t(x).to(torch.bfloat16), tq).float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())


def _planes(k, n, group, packed, lead=()):
    data = torch.zeros((*lead, k // 2 if packed else k, n), dtype=torch.uint8)
    scale = torch.ones((*lead, k // group, n))
    return QTensor(data, scale, scale.clone(), group_size=group, packed=packed,
                   code_bits=4 if packed else 8)


# (packed, K, group, bank): True where the CUDA wrappers take it
GROUP_RULES = {
    "w4_g32": (True, 512, 32, False, True), "w4_g64": (True, 512, 64, False, True),
    "w4_g128": (True, 512, 128, False, True), "w4_g96": (True, 384, 96, False, False),
    "w4_g256": (True, 512, 256, False, False), "w4_bank_g64": (True, 512, 64, True, True),
    "w4_bank_g96": (True, 384, 96, True, False), "w8_bank_g96": (False, 384, 96, True, False),
    "w8_g16": (False, 512, 16, False, True), "w8_g64": (False, 512, 64, False, True),
    "w8_g128": (False, 512, 128, False, True), "w8_gK": (False, 384, 384, False, True),
    "w8_g256_of_384": (False, 384, 256, False, False), "w8_g96": (False, 384, 96, False, False),
    "w8_bank_g128": (False, 512, 128, True, True), "w8_bank_g16": (False, 512, 16, True, True),
}


@pytest.mark.parametrize("case", list(GROUP_RULES))
def test_kernel_group_size_rules(case):
    """W4 takes groups of 32, 64 and 128 (dividing K/2); W8 16, 32, 64 and
    multiples of 128 dividing K (per-column: g = K); a bank the same sizes
    as one matrix; anything else raises naming the size."""
    packed, k, group, bank, ok = GROUP_RULES[case]
    qt = _planes(k, 64, group, packed, lead=(2,) if bank else ())
    if ok:
        qm._check_planes(qt)
    else:
        with pytest.raises(ValueError, match=f"not {group}"):
            qm._check_planes(qt)


def _meta_planes(n, k, group, packed):
    m = dict(device="meta")
    return QTensor(torch.empty((k // 2 if packed else k, n), dtype=torch.uint8, **m),
                   torch.empty((k // group, n), **m), torch.empty((k // group, n), **m),
                   group_size=group, packed=packed, code_bits=4 if packed else 8)


def test_kernel_workspace_covers_wide_groups(monkeypatch):
    """Qwen2.5-7B's projections as GPTQ 4-bit (W4 at group 128) and 8-bit
    (W8 at group 128), and a per-column one (g = K), at every row count of
    an engine of 8 slots and 256-token chunks: ``kernel_workspace`` is the
    largest split state any launch takes (the W8 prefill body's plan reads
    one scale row a stage at these groups)."""
    cfg = ModelConfig(arch="qwen2", vocab_size=152064, hidden_size=3584,
                      intermediate_size=18944, num_layers=1, num_heads=28, num_kv_heads=4,
                      head_dim=128, max_position_embeddings=1024)
    shapes = {"wqkv": (4608, 3584), "wo": (3584, 3584), "wgateup": (37888, 3584),
              "down": (3584, 18944)}
    layers = [{f"{key}_{bits}": _meta_planes(n, k, 128, bits == 4)
               for key, (n, k) in shapes.items() for bits in (4, 8)}]
    layers[0]["per_column"] = _meta_planes(3584, 18944, 18944, False)
    weights = {"layers": layers}
    rows = forward_rows(8, 256, 4)
    want = tll.kernel_workspace(weights, cfg, 8, rows, decode_widths(1024, 16), 16, 132)
    calls = [_matmul_call(qt, m) for qt in layers[0].values() for m in rows]
    got = _recorded_split_state(monkeypatch, calls)
    assert got[0] == want[0] > 0 and got[1] <= want[1]


# ---------------------------------------------------------------------------
# HF directories
# ---------------------------------------------------------------------------

# kind: (architecture, quantization_config, attention biases)
DIRS = {
    "llama_gptq4": ("LlamaForCausalLM", {"quant_method": "gptq", "bits": 4, "group_size": 128,
                                         "sym": True, "desc_act": False}, False),
    "qwen2_gptq8": ("Qwen2ForCausalLM", {"quant_method": "gptq", "bits": 8, "group_size": 128,
                                         "sym": True, "desc_act": False}, True),
    "llama_awq": ("LlamaForCausalLM", {"quant_method": "awq", "bits": 4, "group_size": 128,
                                       "zero_point": True, "version": "gemm"}, False),
}
H, I, V, NL, NH, NKV, HD = 256, 512, 128, 2, 4, 2, 64
PROJ = {"self_attn.q_proj": (NH * HD, H), "self_attn.k_proj": (NKV * HD, H),
        "self_attn.v_proj": (NKV * HD, H), "self_attn.o_proj": (H, NH * HD),
        "mlp.gate_proj": (I, H), "mlp.up_proj": (I, H), "mlp.down_proj": (H, I)}


def _hf_dir(path, kind, seed, quant_config=None, g_idx=False):
    """A tiny checkpoint of ``kind``: f16 embedding, head and norms, every
    projection as its GPTQ or AWQ triplet; returns the state dict."""
    arch, qc, biases = DIRS[kind]
    awq, bits, sym = qc["quant_method"] == "awq", int(qc["bits"]), qc.get("sym", False)
    qc = dict(qc if quant_config is None else quant_config)
    rng = np.random.default_rng(seed)
    cfg = {"architectures": [arch], "model_type": "qwen2" if arch.startswith("Qwen") else "llama",
           "vocab_size": V, "hidden_size": H, "intermediate_size": I, "num_hidden_layers": NL,
           "num_attention_heads": NH, "num_key_value_heads": NKV, "head_dim": HD,
           "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "max_position_embeddings": 128,
           "tie_word_embeddings": False, "quantization_config": qc}

    def f16(*shape, s=0.1, base=0.0):
        return (base + s * rng.standard_normal(shape)).astype(np.float16)

    sd = {"model.embed_tokens.weight": f16(V, H, s=1.0), "model.norm.weight": f16(H, base=1),
          "lm_head.weight": f16(V, H, s=0.05)}
    for li in range(NL):
        p = f"model.layers.{li}."
        sd[p + "input_layernorm.weight"] = f16(H, base=1)
        sd[p + "post_attention_layernorm.weight"] = f16(H, base=1)
        for name, (n, k) in PROJ.items():
            qw, qz, s = draw_layer(rng, k, n, 128, bits, awq=awq, sym=sym, std=1 / np.sqrt(k))
            sd.update({f"{p}{name}.qweight": qw, f"{p}{name}.qzeros": qz,
                       f"{p}{name}.scales": s})
            if g_idx:
                sd[f"{p}{name}.g_idx"] = (np.arange(k, dtype=np.int32) // 128)[::-1].copy()
            elif not awq:
                sd[f"{p}{name}.g_idx"] = np.arange(k, dtype=np.int32) // 128
        if biases:
            for t in "qkv":
                n = PROJ[f"self_attn.{t}_proj"][0]
                sd[f"{p}self_attn.{t}_proj.bias"] = f16(n)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    write_safetensors(path / "model.safetensors", sd)
    return sd


def _weights_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _weights_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _weights_equal(x, y)
    elif isinstance(a, QTensor):
        assert (a.packed, a.group_size, a.code_bits, a.logical_n) == (
            b.packed, b.group_size, b.code_bits, b.logical_n)
        for name in ("data", "scale", "bias"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), name
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", list(DIRS))
def test_hf_dir_matches_jax(tmp_path, kind):
    """Both loaders on the tiny directory: the port's weights equal the JAX
    loader's carried across (planes bit for bit, the f16 embedding, head
    and norms cast alike); f32 ``forward_paged`` logits at every prefill
    chunk and decode step within 5e-3 of JAX's largest (module docstring);
    the planar q/k/v fused with
    their biases (qwen2), every projection in the kernels' wide-group
    layout (W4 packed at 4 bits, W8 unsigned with a bias plane at 8)."""
    _hf_dir(tmp_path, kind, seed=len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _weights_equal(pipe.weights, carried)
    weights = fuse_projections(pipe.weights, cfg)
    lw = weights["layers"][0]
    assert ("wqkv_bias" in lw) == (kind == "qwen2_gptq8")
    for key in ("wqkv", "wo", "wgateup", "down"):
        qt = lw[key]
        assert isinstance(qt, QTensor) and qt.group_size == 128
        assert (qt.packed, qt.data.dtype) == ((False, torch.uint8) if kind == "qwen2_gptq8"
                                              else (True, torch.uint8))
        qm._check_planes(qt)  # the CUDA wrapper takes it
    assert weights["embed"].dtype == torch.float32
    bs, w = 8, 8
    bt, steps = _steps((21, 18), 8, 3, bs, w, seed=3)
    tc = PagedKVCache.create(cfg, 2 * w, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, 2 * w, bs, dtype=jnp.float32)
    reset_counts()
    for i, (ids, pos, slots, kv_lens, last) in enumerate(steps):
        decode = ids.shape[1] == 1
        jl, jc = jax_forward(jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
                             jnp.asarray(slots), jnp.asarray(kv_lens), block_size=bs,
                             backend="xla", compute_dtype=jnp.float32,
                             last_indices=None if decode else jnp.asarray(last))
        tl, tc = forward_paged(weights, cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(pos).long(), tc, torch.from_numpy(bt),
                               torch.from_numpy(slots), torch.from_numpy(kv_lens),
                               block_size=bs, compute_dtype=torch.float32,
                               last_indices=None if decode else torch.from_numpy(last))
        ref = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=5e-3 * np.abs(ref).max(),
                                   err_msg=f"{kind} step {i}")
    name = "w8_matmul_wide_plain" if kind == "qwen2_gptq8" else "w4_matmul_wide_plain"
    assert COUNTS[name] == 4 * NL * len(steps)


def test_engine_greedy_matches_jax(tmp_path):
    """f32 engines on the tiny Llama GPTQ 4-bit directory: a 20-token and a
    13-token prompt in 8-token chunks, 6 greedy tokens each."""
    _hf_dir(tmp_path, "llama_gptq4", seed=11)
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg), compute_dtype=torch.float32,
                device="cpu", **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, n).tolist() for n in (20, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=6)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=6)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 6 for s in ts)


REFUSALS = {
    "act_order": ("llama_gptq4", None, "act-order"),
    "bits3": ("llama_gptq4", {"quant_method": "gptq", "bits": 3, "group_size": 128}, "3 bits"),
    "awq_gemv": ("llama_awq", {"quant_method": "awq", "bits": 4, "group_size": 128,
                               "version": "gemv"}, "gemv"),
    "lm_head_qweight": ("llama_gptq4", None, "lm_head"),
    "gptq_moe": ("llama_gptq4", None, "act-order"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(tmp_path, case):
    """What stays unported raises ``NotImplementedError`` naming it: an
    act-order ``g_idx`` (the JAX loader refuses it too), 3 bits, AWQ's GEMV
    packing, a quantized head (the JAX loader would tie it to the
    embedding), and on a GPTQ Mixtral (its MLP as two experts) an act-order
    ``g_idx`` on one expert."""
    kind, qc, match = REFUSALS[case]
    sd = _hf_dir(tmp_path, kind, seed=1, quant_config=qc, g_idx=case == "act_order")
    if case == "lm_head_qweight":
        qw, qz, s = draw_layer(np.random.default_rng(2), H, V, 128, 4)
        sd.pop("lm_head.weight")
        sd.update({"lm_head.qweight": qw, "lm_head.qzeros": qz, "lm_head.scales": s})
        write_safetensors(tmp_path / "model.safetensors", sd)
    if case == "gptq_moe":
        cfg = json.loads((tmp_path / "config.json").read_text())
        cfg.update(architectures=["MixtralForCausalLM"], model_type="mixtral",
                   num_local_experts=2, num_experts_per_tok=2)
        (tmp_path / "config.json").write_text(json.dumps(cfg))
        for li in range(NL):
            p = f"model.layers.{li}."
            sd[p + "block_sparse_moe.gate.weight"] = np.zeros((2, H), np.float16)
            for hf, w in (("gate_proj", "w1"), ("up_proj", "w3"), ("down_proj", "w2")):
                for part in (".qweight", ".qzeros", ".scales", ".g_idx"):
                    t = sd.pop(f"{p}mlp.{hf}{part}")
                    for e in range(2):
                        sd[f"{p}block_sparse_moe.experts.{e}.{w}{part}"] = t
        k = PROJ["mlp.down_proj"][1]  # expert 1 of the last layer: act-order
        sd[f"{p}block_sparse_moe.experts.1.w2.g_idx"] = (np.arange(k, dtype=np.int32)
                                                        // 128)[::-1].copy()
        write_safetensors(tmp_path / "model.safetensors", sd)
    with pytest.raises(NotImplementedError, match=match):
        load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")


def test_w4_group96_refused_by_the_kernel():
    """A GPTQ 4-bit layer at group 96 with K/2 % 96 == 0 lands in the W4
    layout (the plain version takes it), and the W4 kernel's wrapper refuses
    it naming the size."""
    qw, qz, s = draw_layer(np.random.default_rng(9), 192, 64, 96, 4)
    qt = gptq_awq.gptq_to_qtensor(_t(qw), _t(qz), _t(s))
    assert qt.packed and qt.group_size == 96
    x = torch.randn(2, 192, generator=torch.Generator().manual_seed(0))
    got = qm.quant_matmul(x, qt, compute_dtype=torch.float32)
    assert torch.allclose(got, x @ qt.dequantize().T, atol=1e-5)
    with pytest.raises(ValueError, match="not 96"):
        qm._check_planes(qt)
