"""In-situ quantization (ISQ) in the port, on the CPU, held against the JAX
package on inputs drawn with numpy from a seed.

* The quantizers (``gguf/quants.py``): the port's bytes equal JAX
  ``quants.quantize`` for Q8_0, Q4_0, Q5_0, Q4_K, Q5_K and Q6_K, and JAX
  ``quantize_imatrix`` for Q4_K and Q5_K with 1-D and 2-D importance
  weights, bit for bit, on normal and Student-t rows, an all-zero and a
  constant super-block (the grid search's ``flat`` branch), all-positive
  groups (its ``pos_min`` branch), magnitudes whose f16 ``d`` is subnormal,
  and rows built so that scaled values land exactly on .5. No block of any
  type differs, so no near-tie of the Q4_K/Q5_K grid search has to be
  excused.
* The plan (``default_isq_plan``) and ``parse_isq`` agree with JAX's over a
  list of names, shapes and spellings.
* Whole loads: ``weights_from_state_dict(isq=...)`` on tiny llama (untied
  head, Q4_K with an imatrix; tied, Q6_K), Mixtral (Q5_K; router N = 8) and
  qwen2moe (Q4_K; router N = 60, shared-expert gate N = 1, a dense down
  bank at K = 64) state dicts gives planes bit-equal to JAX's ISQ'd weights
  carried across by ``from_jax_params`` (routers and gates padded to 16
  rows in both), and f32 ``forward_paged`` logits at a prefill chunk and a
  decode step within 1e-2 of the largest of JAX's (``backend="xla"``; both
  round the activations entering each quantized product to bf16, as the
  earlier quantized slices' tests note). A Q4_K engine's greedy tokens
  equal the JAX engine's.
* Entry points: ``load_pipeline(dir, isq="q4k", imatrix=npz)``, ``cli serve
  --isq`` (parsed and loaded in-process; its server stopped before it
  serves), and a ``.gguf`` file and a DeepSeek directory with ``isq``,
  which load unquantized with a warning, as the JAX package ignores it.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.gguf import quants as jax_quants
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import default_isq_plan as jax_isq_plan
from mistralrs_tpu.models.hf_loader import weights_from_state_dict as jax_wfsd
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.pipeline import ISQ_NAMES as JAX_ISQ_NAMES
from mistralrs_tpu.pipeline import parse_isq as jax_parse_isq
from mistralrs_tpu_torch import cli
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.quants import quantize
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import config_from_hf
from mistralrs_tpu_torch.models.hf_loader import default_isq_plan, weights_from_state_dict
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.pipeline import ISQ_NAMES, load_pipeline, parse_isq
from mistralrs_tpu_torch.quant.linear import linear
from mistralrs_tpu_torch.quant.qtensor import QTensor
from mistralrs_tpu_torch.serving.server import Server

from test_torch_deepseek import V2, state_dict as deepseek_state_dict, write_safetensors
from test_torch_gptq_awq import _weights_equal
from test_torch_llama import GGUF_KW, _write_q4k_gguf, jax_to_numpy
from test_torch_qwen import _steps

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The quantizers run ~30 small torch ops a grid step: beside the
    suite's other workers an intra-op thread pool spends each of them
    waiting on its threads (the file took 20x its time alone), so they run
    on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TYPES = ("Q8_0", "Q4_0", "Q5_0", "Q4_K", "Q5_K", "Q6_K")
BLOCK_BYTES = {"Q8_0": 34, "Q4_0": 18, "Q5_0": 22, "Q4_K": 144, "Q5_K": 176, "Q6_K": 210}
# byte offset of each type's f16 super-scale d
D_OFFSET = {"Q8_0": 0, "Q4_0": 0, "Q5_0": 0, "Q4_K": 0, "Q5_K": 0, "Q6_K": 208}


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

def _halves(rng) -> np.ndarray:
    """Rows whose scaled values land on .5: blocks of 32 whose extreme is
    127 (Q8_0's d = 1), -8 (Q4_0's d = 1) or -16 (Q5_0's d = 1), the other
    values k + 0.5 inside the extreme's range."""
    rows = []
    for ext in (127.0, -8.0, -16.0):
        lim = abs(ext) - 1
        x = rng.integers(-lim, lim, (2, 512)).astype(np.float32) + 0.5
        x[:, ::32] = ext
        rows.append(x)
    return np.concatenate(rows)


def _inputs() -> np.ndarray:
    """Every test input of the quantizers as rows of 512 (two super-blocks)."""
    rng = np.random.default_rng(0)
    normal = (rng.standard_normal((8, 512)) * 0.02).astype(np.float32)
    heavy = (rng.standard_t(3, (8, 512)) * 0.02).astype(np.float32)
    edges = rng.standard_normal((4, 512)).astype(np.float32)
    edges[0, :256] = 0.0  # an all-zero super-block
    edges[1, :256] = -0.25  # a constant one (flat groups)
    edges[1, 256:] = 0.125
    edges[2] = np.abs(edges[2]) + 0.05  # all-positive groups (pos_min)
    edges[3, 64:96] = np.abs(edges[3, 64:96]) + 1.0
    subnormal = (rng.standard_normal((4, 512)) * 1e-4).astype(np.float32)
    return np.concatenate([normal, heavy, edges, subnormal, _halves(rng)])


@pytest.mark.parametrize("name", TYPES)
def test_quantize_bytes_equal_jax(name):
    """Every block of every input bit-equal to JAX ``quantize``'s; some
    blocks of the small-magnitude rows carry a subnormal f16 ``d``."""
    x = _inputs()
    want = jax_quants.quantize(x, JaxType[name])
    got = quantize(torch.from_numpy(x), GGMLType[name])
    assert got.dtype == torch.uint8 and got.shape == want.shape
    nb = want.size // BLOCK_BYTES[name]
    differ = (got.numpy().reshape(nb, -1) != want.reshape(nb, -1)).any(axis=1)
    assert not differ.any(), f"{name}: {int(differ.sum())} of {nb} blocks differ"
    d = want.reshape(nb, -1)[:, D_OFFSET[name]:D_OFFSET[name] + 2].copy().view(np.float16)
    assert ((d != 0) & (np.abs(d) < np.finfo(np.float16).tiny)).any(), "no subnormal d"


@pytest.mark.parametrize("name", ["Q4_K", "Q5_K"])
@pytest.mark.parametrize("dims", [1, 2])
def test_quantize_imatrix_bytes_equal_jax(name, dims):
    """Importance-weighted Q4_K/Q5_K (a per-column vector broadcast over
    rows, or a full matrix, some weights under the 1e-10 floor) bit-equal to
    JAX ``quantize_imatrix``, and different from the unweighted bytes."""
    x = _inputs()
    rng = np.random.default_rng(5 + dims)
    w = rng.random(x.shape[-1] if dims == 1 else x.shape).astype(np.float32) ** 3
    w.reshape(-1)[::97] = 0.0
    want = jax_quants.quantize_imatrix(x, JaxType[name], w)
    got = quantize(torch.from_numpy(x), GGMLType[name], torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != quantize(torch.from_numpy(x), GGMLType[name]).numpy()).any()


def test_other_types_ignore_importance_weights():
    """Q8_0, Q4_0, Q5_0, Q6_K, Q2_K and Q3_K quantize as they do without
    weights (JAX ``quantize_imatrix`` falls back alike); a type neither
    package quantizes (Q4_1) raises."""
    x = torch.from_numpy(_inputs()[:8])
    w = torch.rand(x.shape[-1])
    for name in ("Q8_0", "Q4_0", "Q5_0", "Q6_K", "Q2_K", "Q3_K"):
        assert torch.equal(quantize(x, GGMLType[name], w), quantize(x, GGMLType[name]))
    with pytest.raises(NotImplementedError, match="Q4_1"):
        quantize(x, GGMLType.Q4_1)
    with pytest.raises(ValueError, match="blocks of 256"):
        quantize(x[:, :100], GGMLType.Q4_K)


# ---------------------------------------------------------------------------
# the plan and the names
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ("layers.attn_norm", (256,)), ("layers.post_ffn_norm", (256,)), ("layers.q_norm", (64,)),
    ("layers.wq", (256, 256)), ("layers.wq_bias", (256,)), ("layers.wo", (256, 384)),
    ("layers.router", (8, 256)), ("layers.router", (32, 2880)),
    ("layers.shared_expert_gate", (1, 2048)), ("layers.se_down", (2048, 5632)),
    ("layers.exp_gate", (1408, 2048)), ("layers.exp_down", (2048, 1408)),
    ("layers.oss_gate_up", (32, 2880, 5760)), ("embed_tokens", (128, 256)),
    ("embed_tokens", (128, 100)), ("lm_head", (151936, 2048)), ("layers.input_layernorm", (4, 256)),
]


def test_isq_plan_matches_jax():
    """For no ISQ and each ISQ type: the same type (or none) for every name
    and shape of ``PLAN_CASES`` (norms, biases, non-2-D tensors and K not a
    multiple of 256 dense; embedding and head Q8_0)."""
    for t in (None, *TYPES):
        port = default_isq_plan(None if t is None else GGMLType[t])
        ref = jax_isq_plan(None if t is None else JaxType[t])
        for name, shape in PLAN_CASES:
            got, want = port(name, shape), ref(name, shape)
            assert (got and got.name) == (want and want.name), (t, name, shape)


def test_parse_isq_matches_jax():
    """The same names to the same types; ``None``, ``"none"`` and ``""`` to
    none; case and spaces ignored; unknown names refused with JAX's
    message."""
    assert {k: v.name for k, v in ISQ_NAMES.items()} == {
        k: v.name for k, v in JAX_ISQ_NAMES.items()}
    for name in (*ISQ_NAMES, None, "none", "", " Q4K ", "Q8_0"):
        got, want = parse_isq(name), jax_parse_isq(name)
        assert (got and got.name) == (want and want.name), name
    for name in ("q2k", "q3_k", "q4_1", "int4", "fp8"):
        with pytest.raises(ValueError) as port_err:
            parse_isq(name)
        with pytest.raises(ValueError) as jax_err:
            jax_parse_isq(name)
        assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# whole loads
# ---------------------------------------------------------------------------

H, V, NL = 256, 128, 2
# kind: (architecture, ISQ name, tied head, experts, top-k, expert width,
# shared expert width, imatrix)
KINDS = {
    "llama_q4k_imatrix": ("LlamaForCausalLM", "q4k", False, 0, 0, 0, 0, True),
    "llama_tied_q6k": ("LlamaForCausalLM", "q6k", True, 0, 0, 0, 0, False),
    "mixtral_q5k": ("MixtralForCausalLM", "q5k", False, 8, 2, 256, 0, False),
    "qwen2moe_q4k": ("Qwen2MoeForCausalLM", "q4k", False, 60, 4, 64, 256, False),
}


def _case(kind, seed=0):
    """(HF config dict, f16 numpy state dict, imatrix or None) of a tiny
    2-layer checkpoint: hidden 256, 4 query heads of 64 on 2 KV heads, an
    MLP of 512 (llama), vocab 128; norms 1 + N(0, 0.1^2), routers N(0,
    0.5^2), projections of std 1/sqrt(K)."""
    arch, _, tied, e, top, mi, si, with_im = KINDS[kind]
    rng = np.random.default_rng(seed)
    qd, kvd, inter = 4 * 64, 2 * 64, 512
    model_type = {"LlamaForCausalLM": "llama", "MixtralForCausalLM": "mixtral",
                  "Qwen2MoeForCausalLM": "qwen2_moe"}[arch]
    cfg = {"architectures": [arch], "model_type": model_type, "vocab_size": V,
           "hidden_size": H, "intermediate_size": inter, "num_hidden_layers": NL,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
           "rms_norm_eps": 1e-6, "rope_theta": 1e4, "max_position_embeddings": 128,
           "tie_word_embeddings": tied}
    if arch.startswith("Mixtral"):
        cfg.update(num_local_experts=e, num_experts_per_tok=top, intermediate_size=mi)
    elif e:
        cfg.update(num_experts=e, num_experts_per_tok=top, moe_intermediate_size=mi,
                   shared_expert_intermediate_size=si, norm_topk_prob=False,
                   decoder_sparse_step=1, mlp_only_layers=[], use_sliding_window=False)

    def f16(*shape, s=None, base=0.0):
        s = shape[-1] ** -0.5 if s is None else s
        return (base + s * rng.standard_normal(shape)).astype(np.float16)

    sd = {"model.embed_tokens.weight": f16(V, H, s=1.0), "model.norm.weight": f16(H, s=0.1, base=1)}
    if not tied:
        sd["lm_head.weight"] = f16(V, H)
    for li in range(NL):
        p = f"model.layers.{li}."
        sd[p + "input_layernorm.weight"] = f16(H, s=0.1, base=1)
        sd[p + "post_attention_layernorm.weight"] = f16(H, s=0.1, base=1)
        for t, (n, k) in {"q": (qd, H), "k": (kvd, H), "v": (kvd, H), "o": (H, qd)}.items():
            sd[f"{p}self_attn.{t}_proj.weight"] = f16(n, k)
        if arch.startswith("Mixtral"):
            sd[p + "block_sparse_moe.gate.weight"] = f16(e, H, s=0.5)
            for j in range(e):
                for w, (n, k) in (("w1", (mi, H)), ("w3", (mi, H)), ("w2", (H, mi))):
                    sd[f"{p}block_sparse_moe.experts.{j}.{w}.weight"] = f16(n, k)
        elif e:
            sd[p + "mlp.gate.weight"] = f16(e, H, s=0.5)
            for j in range(e):
                for w, (n, k) in (("gate_proj", (mi, H)), ("up_proj", (mi, H)),
                                  ("down_proj", (H, mi))):
                    sd[f"{p}mlp.experts.{j}.{w}.weight"] = f16(n, k)
            for w, (n, k) in (("gate_proj", (si, H)), ("up_proj", (si, H)),
                              ("down_proj", (H, si))):
                sd[f"{p}mlp.shared_expert.{w}.weight"] = f16(n, k)
            sd[p + "mlp.shared_expert_gate.weight"] = f16(1, H, s=0.3)
        else:
            for w, (n, k) in (("gate_proj", (inter, H)), ("up_proj", (inter, H)),
                              ("down_proj", (H, inter))):
                sd[f"{p}mlp.{w}.weight"] = f16(n, k)
    im = None
    if with_im:
        im = {tap: (rng.random((NL, k)) ** 2 + 0.01).astype(np.float32)
              for tap, k in (("attn_in", H), ("o_in", qd), ("mlp_in", H), ("down_in", inter))}
    return cfg, sd, im


def _load_both(kind, seed=0):
    """(JAX config, JAX weights, port config, port weights) of ``kind``,
    f32 dense leaves, quantized in situ by each package."""
    hf_cfg, sd, im = _case(kind, seed)
    isq = KINDS[kind][1]
    jcfg, cfg = jax_config_from_hf(hf_cfg), config_from_hf(hf_cfg)
    jw = jax_wfsd(sd, jcfg, dtype=jnp.float32, isq=jax_parse_isq(isq), imatrix=im)
    tw = weights_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                 dtype=torch.float32, device="cpu", isq=parse_isq(isq),
                                 imatrix=im)
    return jcfg, jw, cfg, tw


@pytest.mark.parametrize("kind", list(KINDS))
def test_isq_weights_and_logits_match_jax(kind):
    """Both packages' ISQ'd weights: the port's equal JAX's carried across
    (planes bit for bit; the embedding and head Q8_0, the projections in the
    ISQ type; routers and shared-expert gates padded to 16 rows with their
    N kept; qwen2moe's down bank dense); the padded matrices pass the CUDA
    wrappers' plane checks and stay unfused; f32 logits at a prefill chunk
    and a decode step within 1e-2 of the largest of JAX's."""
    jcfg, jw, cfg, tw = _load_both(kind)
    isq = parse_isq(KINDS[kind][1])
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _weights_equal(tw, carried)
    assert tw["embed"].ggml_type == GGMLType.Q8_0
    assert (tw["lm_head"] is None) == KINDS[kind][2]
    lw = tw["layers"][1]
    assert lw["wq"].ggml_type == isq and isinstance(lw["attn_norm"], torch.Tensor)
    if cfg.num_experts:
        for key, n in (("router", cfg.num_experts), ("shared_expert_gate", 1)):
            if key in lw:
                qt = lw[key]
                assert qt.logical_n == carried["layers"][1][key].logical_n == n
                assert qt.out_features % 16 == 0 and qt.out_features - n < 16
                qm._check_planes(qt)  # the W4/W8 wrappers take it
        down = lw["experts"]["down"]
        assert isinstance(down, QTensor) == (kind == "mixtral_q5k")
    weights = fuse_projections(tw, cfg)
    if cfg.num_experts:
        assert isinstance(weights["layers"][0]["router"], QTensor)
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
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max(),
                                   err_msg=f"{kind} step {i}")


def test_padded_router_product():
    """A Q4_K router of 8 rows, padded to 16: ``linear`` gives 8 outputs,
    equal to the unpadded planes' plain product; the padded rows' planes
    are zero."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, H)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((8, H)).astype(np.float32))
    from mistralrs_tpu_torch.gguf.planar import to_planar
    raw = quantize(w, GGMLType.Q4_K)
    qt = QTensor.from_planar(to_planar(raw, GGMLType.Q4_K), (8, H), device="cpu")
    padded = qt.pad_rows(16)
    assert padded.out_features == 16 and padded.logical_n == 8 and qt.pad_rows(8) is qt
    for p in (padded.data, padded.scale, padded.bias):
        assert not p[..., 8:].any()
    np.testing.assert_array_equal(linear(x, padded).numpy(), linear(x, qt).numpy())
    assert linear(x, padded).shape == (5, 8)


def test_engine_greedy_matches_jax():
    """f32 engines on the Q4_K llama with an imatrix: a 12-token and a
    7-token prompt in 8-token chunks, 4 greedy tokens each, identical."""
    jcfg, jw, cfg, tw = _load_both("llama_q4k_imatrix", seed=7)
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(cfg, fuse_projections(tw, cfg), compute_dtype=torch.float32, device="cpu",
                **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, n).tolist() for n in (12, 7)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=4)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=4)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 4 for s in ts)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _write_dir(path, kind, seed=0, tokenizer=False):
    hf_cfg, sd, im = _case(kind, seed)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_cfg))
    write_safetensors(path / "model.safetensors", sd)
    if tokenizer:
        tokenizers = pytest.importorskip("tokenizers")
        tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
            {f"w{i}": i for i in range(V)}, unk_token="w0"))
        tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
        tok.save(str(path / "tokenizer.json"))
    return hf_cfg, sd, im


def test_load_pipeline_isq_with_imatrix(tmp_path):
    """``load_pipeline(dir, isq="q4k", imatrix=npz)``: the weights the state
    dict gives ``weights_from_state_dict`` with that imatrix, which differ
    from those without it."""
    hf_cfg, sd, im = _write_dir(tmp_path / "m", "llama_q4k_imatrix")
    np.savez(tmp_path / "im.npz", **im)
    pipe = load_pipeline(str(tmp_path / "m"), isq="q4k", dtype=torch.float32, device="cpu",
                         imatrix=str(tmp_path / "im.npz"))
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = weights_from_state_dict(tsd, pipe.cfg, dtype=torch.float32, device="cpu",
                                   isq=GGMLType.Q4_K, imatrix=im)
    _weights_equal(pipe.weights, want)
    plain = weights_from_state_dict(tsd, pipe.cfg, dtype=torch.float32, device="cpu",
                                    isq=GGMLType.Q4_K)
    assert not torch.equal(plain["layers"][0]["wq"].data, want["layers"][0]["wq"].data)


def test_cli_serve_isq(tmp_path, monkeypatch):
    """``cli serve DIR --isq q5_0``: parsed, the directory quantized at load
    (Q5_0 layers on W8, Q8_0 embedding and head), the engine built on those
    weights; the server is stopped where it would start serving."""
    _write_dir(tmp_path, "llama_tied_q6k", tokenizer=True)
    seen = {}

    def stop(self):
        seen["weights"] = self.resolve(None).engine.weights
        self.shutdown()
        raise KeyboardInterrupt

    monkeypatch.setattr(Server, "serve_forever", stop)
    assert cli.main(["serve", str(tmp_path), "--isq", "q5_0", "--device", "cpu", "--host",
                     "127.0.0.1", "--port", "0", "--max-seq-len", "64"]) == 0
    w = seen["weights"]
    assert w["embed"].ggml_type == GGMLType.Q8_0 and w["lm_head"] is None
    assert w["layers"][0]["wqkv"].ggml_type == GGMLType.Q5_0
    assert not w["layers"][0]["wqkv"].packed and w["layers"][0]["wqkv"].bias is not None
    with pytest.raises(ValueError, match="unknown ISQ type"):
        cli.main(["serve", str(tmp_path), "--isq", "q2k", "--device", "cpu"])


def _quantized_leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [q for t in tree for q in _quantized_leaves(t)]
    return [tree] if isinstance(tree, QTensor) else []


def test_gguf_and_deepseek_ignore_isq(tmp_path, capsys):
    """As the JAX package does, a ``.gguf`` file and a DeepSeek directory
    load unquantized whatever ``isq`` says (the GGUF's own Q4_K planes, the
    DeepSeek bf16 leaves), and the port says so on stderr."""
    path = str(tmp_path / "tiny.gguf")
    _write_q4k_gguf(path, GGUF_KW)
    pipe = load_pipeline(path, isq="q8_0", device="cpu")
    _weights_equal(pipe.weights, load_pipeline(path, device="cpu").weights)
    assert pipe.weights["layers"][0]["wq"].ggml_type == GGMLType.Q4_K
    assert "ignored" in capsys.readouterr().err
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "config.json").write_text(json.dumps(V2))
    write_safetensors(ds / "model.safetensors", deepseek_state_dict(V2, seed=3))
    pipe = load_pipeline(str(ds), isq="q4k", dtype=torch.float32, device="cpu")
    assert pipe.adapter is not None and not _quantized_leaves(pipe.weights)
    err = capsys.readouterr().err
    assert "deepseek_v2" in err and "ignored" in err and "Q4_K" in err
