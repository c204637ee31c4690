"""The weight formats of ``quant/bnb.py``, ``quant/hqq.py``, ``quant/fp8.py``,
``topology.py``, the Q2_K/Q3_K quantizers and Q8_1/Q8_K dequantizers of
``gguf/``, and the ``mistral`` GGUF arch, held against the JAX package on
the CPU with inputs drawn with numpy from a seed (the JAX side on its XLA
path, ``backend="xla"``).

Exact (bit for bit):

* bitsandbytes NF4 and FP4 decode, plain and double-quantized (at most 256
  block scales, where the two packages read the nested scales alike),
  against JAX ``decode_bnb_param``; beyond 256 scales and with the
  ``nested_offset`` key bitsandbytes writes, against a numpy model of
  bitsandbytes' own formula (ROADMAP Queue 3: the JAX package reads
  nested block 0 for every scale, and only an ``offset`` key);
* Q8_1 and Q8_K dequantization, and the Q2_K and Q3_K quantizers' bytes;
* ``Fp8Tensor.quantize`` codes and scales, per tensor and blockwise (128 x
  128, and 64 x 96 over ragged edges), and ``dequantize``;
* HQQ scale planes and ``hqq_from_state``'s planes.

Within a stated tolerance: HQQ codes (at most 1 % of codes, each by one
step: a zero point an f32 ulp apart moves a code at a rounding tie) and
biases (1e-5 of the largest |bias|); the plain ``fp8_matmul`` against JAX
``fp8_matmul`` (1e-3 of the largest |output|: both round x and w to bf16
and sum in f32, in other orders); f32 logits (a prefill chunk and a decode
step, 1e-2 of the largest: both round the activations entering each
quantized product to bf16) of a bitsandbytes directory (NF4 and FP4, double
quantized; and quantized in situ to Q4_K), a topology load (Q2_K, Q3_K,
Q8_0 layers) and a ``mistral`` GGUF file against the JAX loaders'.

Refusals alike: bad topology ranges and types (the same messages), HQQ
forms the W4/W8 kernels refuse (by name), bitsandbytes 8-bit. And the GGUF
reader's header parse past its first 1 MiB read (the metadata equal to JAX's
reader's; a file cut inside its header raises).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.convert import convert_hf_to_gguf as jax_convert
from mistralrs_tpu.gguf import quants as jax_quants
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.writer import GGUFWriter as JaxWriter
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.gguf_loader import load_gguf_model as jax_load_gguf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.hf_loader import weights_from_state_dict as jax_wfsd
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.quant import bnb as jax_bnb
from mistralrs_tpu.quant.fp8 import Fp8Tensor as JaxFp8
from mistralrs_tpu.quant.fp8 import fp8_matmul as jax_fp8_matmul
from mistralrs_tpu.quant.hqq import hqq_from_state as jax_hqq_from_state
from mistralrs_tpu.quant.hqq import hqq_quantize as jax_hqq
from mistralrs_tpu.topology import Topology as JaxTopology
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.planar import dequantize
from mistralrs_tpu_torch.gguf.quants import quantize
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import config_from_hf
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.models.hf_loader import load_hf_model, weights_from_state_dict
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.quant import bnb
from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor, fp8_matmul
from mistralrs_tpu_torch.quant.hqq import hqq_from_state, hqq_quantize
from mistralrs_tpu_torch.quant.qtensor import QTensor
from mistralrs_tpu_torch.topology import Topology

from test_torch_deepseek import write_safetensors
from test_torch_gptq_awq import _weights_equal
from test_torch_isq import _case, _inputs
from test_torch_qwen import _steps


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops (the quantizers, HQQ's solver): one thread, as
    in ``test_torch_isq.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# bitsandbytes
# ---------------------------------------------------------------------------

NESTED_MAP = np.linspace(-1.0, 1.0, 256).astype(np.float32)  # any 256-entry table


def _bnb_sd(stem, w, code, double, offset_key="offset", shared_nested=True):
    """The tensors bitsandbytes stores for a 4-bit ``w`` (``code``: NF4 or
    FP4), codes from JAX ``quantize_4bit``; ``double``: the block scales
    quantized to uint8 indices into ``NESTED_MAP`` over blocks of 256 scales
    (one nested scale shared by all blocks where ``shared_nested``)."""
    packed, absmax = jax_bnb.quantize_4bit(w, code)
    sd = {stem: packed, stem + ".quant_map": code}
    meta = {"quant_type": "nf4" if code is jax_bnb.NF4_CODE else "fp4", "blocksize": 64,
            "shape": list(w.shape), "dtype": "bfloat16"}
    if double:
        off = float(absmax.mean())
        centred = np.pad(absmax - off, (0, -absmax.size % 256)).reshape(-1, 256)
        na = np.abs(centred).max(axis=1).astype(np.float32)
        if shared_nested:
            na[:] = na.max()
        idx = np.abs(centred[..., None] / na[:, None, None] - NESTED_MAP).argmin(-1)
        sd.update({stem + ".absmax": idx.reshape(-1)[:absmax.size].astype(np.uint8),
                   stem + ".nested_absmax": na, stem + ".nested_quant_map": NESTED_MAP})
        meta.update({offset_key: off, "nested_blocksize": 256})
    else:
        sd[stem + ".absmax"] = absmax.astype(np.float32)
    suffix = "nf4" if code is jax_bnb.NF4_CODE else "fp4"
    sd[f"{stem}.quant_state.bitsandbytes__{suffix}"] = np.frombuffer(
        json.dumps(meta).encode(), np.uint8).copy()
    return sd


@pytest.mark.parametrize("code", ["nf4", "fp4"])
@pytest.mark.parametrize("double", [False, True])
def test_bnb_decode_bit_exact(code, double):
    """A [96, 160] weight (240 block scales, an odd element count per row
    pair) decoded by both packages, bit for bit."""
    table = jax_bnb.NF4_CODE if code == "nf4" else jax_bnb.FP4_CODE
    w = np.random.default_rng(1).standard_normal((96, 160)).astype(np.float32)
    sd = _bnb_sd("w", w, table, double)
    want = jax_bnb.decode_bnb_param(sd, "w")
    got = bnb.decode_bnb_param({k: torch.from_numpy(v) for k, v in sd.items()}, "w",
                               device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert bnb.decode_bnb_param({"x": torch.zeros(3)}, "x", device="cpu") is None


def test_bnb_nested_blocks_follow_bitsandbytes():
    """Past 256 scales the port reads nested scale ``i // 256`` for scale
    ``i`` and the ``nested_offset`` key, as bitsandbytes writes them: equal
    to a numpy model of that formula; the port's own ``quantize_4bit`` gives
    JAX ``quantize_4bit``'s bytes."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 384)).astype(np.float32)  # 768 scales: 3 nested blocks
    sd = _bnb_sd("w", w, jax_bnb.NF4_CODE, True, "nested_offset", shared_nested=False)
    meta = json.loads(bytes(sd["w.quant_state.bitsandbytes__nf4"]).decode())
    absmax = (NESTED_MAP[sd["w.absmax"].astype(np.int64)]
              * sd["w.nested_absmax"][np.arange(768) // 256]
              + np.float32(meta["nested_offset"]))
    codes = np.stack([sd["w"][:, 0] >> 4, sd["w"][:, 0] & 15], 1).reshape(-1)
    want = (jax_bnb.NF4_CODE[codes] * np.repeat(absmax, 64)).reshape(w.shape)
    got = bnb.decode_bnb_param({k: torch.from_numpy(v) for k, v in sd.items()}, "w",
                               device="cpu")
    assert np.array_equal(got.numpy(), want)
    packed, am = bnb.quantize_4bit(torch.from_numpy(w))
    jp, ja = jax_bnb.quantize_4bit(w)
    assert np.array_equal(packed.numpy(), jp) and np.array_equal(am.numpy(), ja)


# ---------------------------------------------------------------------------
# GGUF types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Q8_1", "Q8_K"])
def test_q8_1_q8_k_dequant_bit_exact(name):
    """Random blocks with finite scales (f16 for Q8_1, f32 for Q8_K)."""
    rng = np.random.default_rng(3)
    size = {"Q8_1": 36, "Q8_K": 292}[name]
    raw = rng.integers(0, 256, (64, size), dtype=np.uint8)
    if name == "Q8_1":
        raw[:, 0:4] = (rng.standard_normal((64, 2)) * 0.01).astype(np.float16).view(np.uint8)
    else:
        raw[:, 0:4] = (rng.standard_normal((64, 1)) * 0.01).astype(np.float32).view(np.uint8)
    n = 64 * (32 if name == "Q8_1" else 256)
    want = jax_quants.dequantize(raw.reshape(-1), JaxType[name], (n,))
    got = dequantize(torch.from_numpy(raw.reshape(-1)), GGMLType[name], (n,))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["Q2_K", "Q3_K"])
def test_q2k_q3k_quantizer_bytes_equal_jax(name):
    """``test_torch_isq.py``'s rows (normal, Student-t, zero, constant,
    all-positive, subnormal-d, .5 ties): every byte equal."""
    x = _inputs()
    want = jax_quants.quantize(x, JaxType[name])
    got = quantize(torch.from_numpy(x), GGMLType[name])
    assert np.array_equal(got.numpy(), want)


def test_q8_k_tensors_load_dense(tmp_path):
    """A llama GGUF whose ``ffn_down`` is Q8_K and ``attn_v`` Q8_1 in every
    layer: both loaders give the same dense weights."""
    path = str(tmp_path / "q8k.gguf")
    rng = np.random.default_rng(4)
    w = JaxWriter(path)
    w.add_metadata("general.architecture", "llama")
    for key, v in (("block_count", 2), ("embedding_length", 256), ("feed_forward_length", 256),
                   ("attention.head_count", 4), ("attention.head_count_kv", 2),
                   ("context_length", 64), ("vocab_size", 64)):
        w.add_metadata(f"llama.{key}", np.uint32(v))
    w.add_tensor("token_embd.weight", rng.standard_normal((64, 256)).astype(np.float32))
    w.add_tensor("output_norm.weight", np.ones(256, np.float32))
    for i in range(2):
        for name, shape in (("attn_q", (256, 256)), ("attn_k", (128, 256)),
                            ("attn_output", (256, 256)), ("ffn_gate", (256, 256)),
                            ("ffn_up", (256, 256))):
            w.add_tensor(f"blk.{i}.{name}.weight",
                         (rng.standard_normal(shape) * 0.05).astype(np.float32), JaxType.Q8_0)
        for name in ("attn_norm", "ffn_norm"):
            w.add_tensor(f"blk.{i}.{name}.weight", np.ones(256, np.float32))
        for name, t, size, per in (("ffn_down", JaxType.Q8_K, 292, 256),
                                   ("attn_v", JaxType.Q8_1, 36, 32)):
            n = 256 if name == "ffn_down" else 128
            raw = rng.integers(0, 256, (n * 256 // per, size), dtype=np.uint8)
            dt = np.float32 if t == JaxType.Q8_K else np.float16
            raw[:, 0:4] = (np.abs(rng.standard_normal((raw.shape[0], 4 // np.dtype(dt).itemsize)))
                           * 1e-3).astype(dt).view(np.uint8)
            w.add_raw_tensor(f"blk.{i}.{name}.weight", raw, (n, 256), t)
    w.write()
    _, jw, _ = jax_load_gguf(path, dtype=jnp.float32)
    _, tw, _ = load_gguf_model(path, dtype=torch.float32, device="cpu")
    for key in ("down", "wv"):
        for i in range(2):
            got = tw["layers"][i][key]
            assert isinstance(got, torch.Tensor)
            assert np.array_equal(got.numpy(), np.asarray(jw["layers"][key][i]))


# ---------------------------------------------------------------------------
# FP8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", [None, (128, 128), (64, 96)])
def test_fp8_quantize_bit_exact(blocks):
    """Codes, scales and the dequantized weight equal JAX's (a [200, 300]
    weight: ragged blocks at both edges for 128 x 128 and 64 x 96), and the
    plain ``fp8_matmul`` agrees with JAX ``fp8_matmul``."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((200, 300)) * 0.1).astype(np.float32)
    w[3, 7] = 9.0  # one large value in one block
    want = JaxFp8.quantize(w, blocks)
    got = Fp8Tensor.quantize(torch.from_numpy(w), blocks, device="cpu")
    assert np.array_equal(got.data.T.contiguous().view(torch.uint8).numpy(),
                          np.asarray(want.data).view(np.uint8))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert np.array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    x = rng.standard_normal((5, 300)).astype(np.float32)
    ref = np.asarray(jax_fp8_matmul(jnp.asarray(x), want))
    out = fp8_matmul(torch.from_numpy(x), got).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# HQQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 128), (8, 64), (3, 64)])
def test_hqq_matches_jax(bits, group):
    """Scale planes bit for bit, codes equal but at rounding ties (<= 1 %,
    one step each), biases within 1e-5 of the largest, the same packing."""
    rng = np.random.default_rng(bits * group)
    w = (rng.standard_normal((96, 512)) * 0.05).astype(np.float32)
    w[0, :group] = 0.25  # a flat group (scale 1e-8)
    want = jax_hqq(w, bits=bits, group_size=group)
    got = hqq_quantize(torch.from_numpy(w), bits=bits, group_size=group, device="cpu")
    assert (got.packed, got.group_size, got.code_bits) == (want.packed, group, bits)
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    gq = got.unpack_codes().numpy()
    jd = np.asarray(want.data).astype(np.int32)
    jq = np.concatenate([jd & 15, jd >> 4], axis=0) if want.packed else jd
    diff = np.abs(gq - jq)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())
    jb = np.asarray(want.bias)
    np.testing.assert_allclose(got.bias.numpy(), jb, rtol=0, atol=1e-5 * np.abs(jb).max())


def test_hqq_from_state_exact():
    rng = np.random.default_rng(6)
    n, k, gs = 64, 256, 64
    wq = rng.integers(0, 16, n * k).astype(np.uint8)
    scale = rng.random(n * k // gs).astype(np.float32) * 0.01
    zero = (rng.random(n * k // gs) * 15).astype(np.float32)
    want = jax_hqq_from_state(wq, scale, zero, (n, k))
    got = hqq_from_state(torch.from_numpy(wq), torch.from_numpy(scale),
                         torch.from_numpy(zero), (n, k), device="cpu")
    for name in ("data", "scale", "bias"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name


@pytest.mark.parametrize("bits,group,k", [(4, 256, 512), (8, 96, 384), (9, 64, 256),
                                          (4, 64, 192)])
def test_hqq_refuses_forms_the_kernels_refuse(bits, group, k):
    """4-bit at group 256, 8-bit at 96, 9 bits, and 4-bit codes that cannot
    pack (K/2 = 96 at group 64) on W8 at group 64 over K = 192 (W8 takes
    it: no refusal there)."""
    w = torch.randn(32, k)
    if (bits, group, k) == (4, 64, 192):
        qt = hqq_quantize(w, bits=bits, group_size=group, device="cpu")
        assert not qt.packed and qt.group_size == 64
        return
    with pytest.raises(ValueError, match="HQQ"):
        hqq_quantize(w, bits=bits, group_size=group, device="cpu")


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def test_topology_matches_jax():
    spec = {"0-1": {"isq": "Q2K"}, "1-": {"isq": "q3k"}, "3-5": {"isq": "Q8_0"},
            "4-5": {"isq": None}}
    got = Topology.from_dict(spec, 6, GGMLType.Q4_K)
    want = JaxTopology.from_dict(spec, 6, JaxType.Q4_K)
    assert [t and t.name for t in got.per_layer] == [t and t.name for t in want.per_layer]
    yaml_text = "0-2:\n  isq: Q6K\n2-:\n  isq: Q5_0\n"
    assert ([t.name for t in Topology.from_yaml(yaml_text, 4).per_layer]
            == [t.name for t in JaxTopology.from_yaml(yaml_text, 4).per_layer])
    for bad in ({"x-2": {}}, {"2-9": {"isq": "Q4K"}}, {"3-1": {}}, {"0-1": {"isq": "int4"}}):
        with pytest.raises(ValueError) as port_err:
            Topology.from_dict(bad, 6)
        with pytest.raises(ValueError) as jax_err:
            JaxTopology.from_dict(bad, 6)
        assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# whole models against the JAX loaders
# ---------------------------------------------------------------------------


def logits_match(jcfg, jw, cfg, tw, tol=1e-2):
    """f32 ``forward_paged`` logits of a prefill chunk (rows of 21 and 18
    tokens) and a decode step, the port's (weights fused) within ``tol`` of
    the largest of JAX's."""
    weights = fuse_projections(tw, cfg)
    bs, w = 8, 8
    bt, steps = _steps((21, 18), 24, 1, bs, w, seed=3)
    tc = PagedKVCache.create(cfg, 2 * w, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, 2 * w, bs, dtype=jnp.float32)
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
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max(),
                                   err_msg=f"step {i}")


def _bnb_dir(path, code, double):
    """The tiny llama of ``test_torch_isq.py`` with every projection stored
    as bitsandbytes 4-bit (the embedding, head and norms f16)."""
    hf_cfg, sd, _ = _case("llama_q4k_imatrix", seed=7)
    table = jax_bnb.NF4_CODE if code == "nf4" else jax_bnb.FP4_CODE
    out = {}
    for name, a in sd.items():
        if "_proj" in name:
            out.update(_bnb_sd(name, a.astype(np.float32), table, double))
        else:
            out[name] = a
    hf_cfg = dict(hf_cfg, quantization_config={"quant_method": "bitsandbytes",
                                               "load_in_4bit": True,
                                               "bnb_4bit_quant_type": code})
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf_cfg))
    write_safetensors(path / "model.safetensors", out)
    return hf_cfg


@pytest.mark.parametrize("code,double,isq", [("nf4", True, None), ("fp4", False, "q4k")])
def test_bnb_dir_matches_jax(tmp_path, code, double, isq):
    """``load_hf_model`` on a bitsandbytes directory: the dense weights
    equal JAX's (f32); quantized in situ, the planes equal JAX's; the
    logits agree."""
    from mistralrs_tpu.pipeline import parse_isq as jax_parse_isq
    from mistralrs_tpu_torch.convert import from_jax_params
    from mistralrs_tpu_torch.pipeline import parse_isq
    from test_torch_llama import jax_to_numpy

    _bnb_dir(tmp_path / "m", code, double)
    jcfg, jw, _ = jax_load_hf(tmp_path / "m", dtype=jnp.float32,
                              isq=None if isq is None else jax_parse_isq(isq))
    cfg, tw, _ = load_hf_model(tmp_path / "m", dtype=torch.float32, device="cpu",
                               isq=None if isq is None else parse_isq(isq))
    _weights_equal(tw, from_jax_params(jax_to_numpy(jw), cfg, device="cpu",
                                       dtype=torch.float32))
    assert isinstance(tw["layers"][0]["wq"], QTensor) == (isq is not None)
    logits_match(jcfg, jw, cfg, tw)


def test_bnb_8bit_refused(tmp_path):
    hf_cfg, sd, _ = _case("llama_tied_q6k")
    hf_cfg["quantization_config"] = {"quant_method": "bitsandbytes", "load_in_8bit": True}
    with pytest.raises(NotImplementedError, match="8-bit"):
        weights_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                config_from_hf(hf_cfg), device="cpu",
                                quant_config=hf_cfg["quantization_config"])


def test_topology_load_matches_jax():
    """ISQ to Q4_K with a topology of Q2_K (layer 0) and Q3_K (layer 1) for
    the projections: each layer keeps its own type in the port (the JAX
    loader widens the stack to int8 codes at group 16, the same values);
    ``isq: null`` falls back to the ISQ type in both; logits agree."""
    hf_cfg, sd, _ = _case("llama_q4k_imatrix", seed=8)
    spec = {"0-1": {"isq": "Q2K"}, "1-2": {"isq": "Q3K"}}
    jcfg, cfg = jax_config_from_hf(hf_cfg), config_from_hf(hf_cfg)
    jw = jax_wfsd(sd, jcfg, dtype=jnp.float32, isq=JaxType.Q4_K,
                  topology=JaxTopology.from_dict(spec, 2))
    tw = weights_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                 dtype=torch.float32, device="cpu", isq=GGMLType.Q4_K,
                                 topology=Topology.from_dict(spec, 2))
    assert tw["layers"][0]["wq"].ggml_type == GGMLType.Q2_K
    assert tw["layers"][1]["down"].ggml_type == GGMLType.Q3_K
    assert tw["embed"].ggml_type == GGMLType.Q8_0  # embedding and head: not the topology's
    logits_match(jcfg, jw, cfg, tw)
    nulls = Topology.from_dict({"0-2": {"isq": None}}, 2)
    tn = weights_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                 dtype=torch.float32, device="cpu", isq=GGMLType.Q4_K,
                                 topology=nulls)
    assert tn["layers"][1]["wq"].ggml_type == GGMLType.Q4_K


def test_mistral_gguf_matches_jax(tmp_path):
    """A ``mistral`` GGUF (q/k rows permuted by the JAX converter, Q4_K
    layers, Q8_0 embedding and head) through both loaders."""
    kw = dict(arch="mistral", vocab_size=128, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
              max_position_embeddings=128, rope_theta=1e6)
    _, sd, _ = _case("llama_q4k_imatrix", seed=9)
    path = str(tmp_path / "tiny-mistral.gguf")
    jax_convert({k: v.astype(np.float32) for k, v in sd.items()}, JaxConfig(**kw), path,
                quant=JaxType.Q4_K)
    jcfg, jw, _ = jax_load_gguf(path, dtype=jnp.float32)
    cfg, tw, _ = load_gguf_model(path, dtype=torch.float32, device="cpu")
    assert cfg.arch == jcfg.arch == "mistral"
    np.testing.assert_array_equal(tw["layers"][1]["wk"].data.numpy(),
                                  np.asarray(jw["layers"]["wk"].data[1]))
    logits_match(jcfg, jw, cfg, tw)


def test_gguf_header_longer_than_the_first_read(tmp_path):
    """The GGUF reader parses its header from file reads (no memory map),
    growing the read past 1 MiB where the metadata needs it (a 3 MiB
    string, a 300k-entry array): the metadata and tensors equal what JAX's
    reader gives; a file cut inside its header raises ``ValueError``."""
    from mistralrs_tpu.gguf.reader import GGUFContent as JaxContent
    from mistralrs_tpu_torch.gguf.reader import GGUFContent

    path = tmp_path / "long.gguf"
    w = JaxWriter(str(path))
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("long.text", "x" * (3 << 20))
    w.add_metadata("long.ids", list(range(300_000)))
    w.add_tensor("t", np.arange(64, dtype=np.float32).reshape(2, 32), JaxType.Q8_0)
    w.write()
    got, want = GGUFContent.open(path), JaxContent.open(path)
    assert got.metadata == want.metadata
    assert np.array_equal(got.tensor_bytes("t"), np.asarray(want.tensor_bytes("t")))
    want.close()
    (tmp_path / "cut.gguf").write_bytes(path.read_bytes()[:2 << 20])
    with pytest.raises(ValueError, match="header"):
        GGUFContent.open(tmp_path / "cut.gguf")
