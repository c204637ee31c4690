"""GGUF files of the ``llama``, ``qwen2``, ``qwen3`` and ``qwen3moe`` archs
through the port's loader against the JAX package's, on the CPU.

Tiny files are written with the JAX package's ``GGUFWriter``: each
projection in its own planar type, so that all ten types load in a model
(JAX ``quantize`` where it has a quantizer; Q4_1, Q5_1 and the expert
banks as blocks drawn by ``gguf/drawn.py``, weights centred on zero), each
key in one type across layers (the JAX loader stacks layers and widens a
key whose layers differ, which the port does not). Qwen2 has q/k/v biases
and a tied head (no ``output.weight``); Qwen3 q/k norms and a head_dim of
128 on a hidden 256 (``attention.key_length``); Qwen3-MoE
in a Q2_K mix (8 experts top-2; Q2_K gate/up banks, Q3_K down banks).
llama.cpp permutes the q/k rows of llama files only; both loaders undo that
for llama alone.

Held against JAX ``load_gguf_model``: the port's weights equal the JAX
weights carried by ``from_jax_params`` bit for bit; ``forward_paged`` in
f32 (a prefill chunk of two rows, 21 and 13 tokens; qwen3moe one decode
step too)
within 1e-2 of the largest |logit| with a correlation over 0.9999: both
dequantize the same weights to bf16 and round the activations entering
every quantized product to bf16, so a last-bit f32 difference of the f32
sum order can move one such rounding (2^-8 of one value), which moves
later logits (measured: up to 3.2e-3 of the largest); a wrong weight, row
order or type moves them by their own size. Then an engine run's greedy
tokens (qwen2), and the tokenizer's ids and the chat
prompt of a Qwen file (``tokenizer.ggml.model`` gpt2, its ``pre``, its
chat template) equal to JAX ``tokenizer.from_gguf_metadata``'s. Then the
refusals by name.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.chat_template import resolve_chat_template as jax_resolve_template
from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.quants import QUANTIZERS
from mistralrs_tpu.gguf.writer import GGUFWriter
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.gguf_loader import load_gguf_model as jax_load_gguf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.tokenizer import from_gguf_metadata as jax_tokenizer
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.drawn import draw_blocks
from mistralrs_tpu_torch.gguf.reader import GGUFContent
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant.qtensor import QTensor

from test_torch_llama import BS, _schedule, jax_to_numpy

H = 256
CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
          "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]

# per arch: config keys and each projection's type (one type a key across layers)
ARCHS = {
    "llama": dict(
        cfg=dict(num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512),
        types=dict(token_embd="Q4_0", output="Q5_0", attn_q="Q4_K", attn_k="Q4_K",
                   attn_v="Q8_0", attn_output="Q5_K", ffn_gate="Q2_K", ffn_up="Q3_K",
                   ffn_down="Q6_K")),
    "qwen2": dict(
        cfg=dict(num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512),
        types=dict(token_embd="Q5_K", attn_q="Q5_K", attn_k="Q5_K", attn_v="Q6_K",
                   attn_output="Q5_1", ffn_gate="Q5_0", ffn_up="Q5_0", ffn_down="Q6_K")),
    "qwen3": dict(
        cfg=dict(num_heads=4, num_kv_heads=2, head_dim=128, intermediate_size=512),
        types=dict(token_embd="Q6_K", output="Q8_0", attn_q="Q4_0", attn_k="Q4_1",
                   attn_v="Q8_0", attn_output="Q3_K", ffn_gate="Q2_K", ffn_up="Q4_K",
                   ffn_down="Q5_1")),
    "qwen3moe": dict(
        cfg=dict(num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512,
                 num_experts=8, num_experts_per_tok=2, moe_intermediate_size=256),
        types=dict(token_embd="Q2_K", output="Q6_K", attn_q="Q2_K", attn_k="Q2_K",
                   attn_v="Q3_K", attn_output="Q2_K", ffn_gate_exps="Q2_K",
                   ffn_up_exps="Q2_K", ffn_down_exps="Q3_K")),
}


def _bpe():
    """A small byte-level BPE (the base alphabet, merges trained by hand
    and Qwen's three special tokens) as GGUF stores one: tokens in id
    order, merges as "a b" strings, token types (3: control)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["hello world", "the quick brown fox", "you are a helpful "
                             "assistant"] * 40, trainer)
    vocab = tok.get_vocab()
    tokens = [None] * len(vocab)
    for t, i in vocab.items():
        tokens[i] = t
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in json.loads(tok.to_str())["model"]["merges"]]
    types = [3 if t in SPECIALS else 1 for t in tokens]
    return tokens, merges, types


def _write(path, arch, seed=0):
    """A tiny 2-layer GGUF of ``arch`` (module docstring) with a gpt2
    tokenizer and the ChatML template."""
    spec = ARCHS[arch]
    kw = spec["cfg"]
    tokens, merges, ttypes = _bpe()
    v, nl, qd, kvd = len(tokens), 2, kw["num_heads"] * kw["head_dim"], kw["num_kv_heads"] * kw["head_dim"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    w = GGUFWriter(path)
    ints = dict(block_count=nl, context_length=512, embedding_length=H,
                feed_forward_length=kw["intermediate_size"], vocab_size=v,
                **{"attention.head_count": kw["num_heads"],
                   "attention.head_count_kv": kw["num_kv_heads"],
                   "attention.key_length": kw["head_dim"]})
    if "num_experts" in kw:
        ints.update(expert_count=kw["num_experts"], expert_used_count=kw["num_experts_per_tok"],
                    expert_feed_forward_length=kw["moe_intermediate_size"])
    w.add_metadata("general.architecture", arch)
    for key, val in ints.items():
        w.add_metadata(f"{arch}.{key}", np.uint32(val))
    w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-6))
    w.add_metadata(f"{arch}.rope.freq_base", np.float32(1e6))
    w.add_metadata("tokenizer.ggml.model", "gpt2")
    w.add_metadata("tokenizer.ggml.pre", "qwen2")
    w.add_metadata("tokenizer.ggml.tokens", tokens)
    w.add_metadata("tokenizer.ggml.merges", merges)
    w.add_metadata("tokenizer.ggml.token_type", ttypes)
    w.add_metadata("tokenizer.ggml.eos_token_id", np.uint32(tokens.index("<|im_end|>")))
    w.add_metadata("tokenizer.ggml.bos_token_id", np.uint32(tokens.index("<|endoftext|>")))
    w.add_metadata("tokenizer.ggml.add_bos_token", False)
    w.add_metadata("tokenizer.chat_template", CHATML)

    def quant(name, shape, t):
        if JaxType[t] in QUANTIZERS and len(shape) == 2:
            w.add_tensor(name, (rng.standard_normal(shape) * 0.05).astype(np.float32),
                         JaxType[t])
        else:  # Q4_1, Q5_1 and the banks: drawn blocks
            w.add_raw_tensor(name, draw_blocks(GGMLType[t], shape, gen, "cpu", std=0.05).numpy(),
                             shape, JaxType[t])

    def f32(name, shape, fill=0.0, std=0.1):
        w.add_tensor(name, (fill + rng.standard_normal(shape) * std).astype(np.float32))

    types = spec["types"]
    quant("token_embd.weight", (v, H), types["token_embd"])
    f32("output_norm.weight", (H,), 1.0)
    if "output" in types:
        quant("output.weight", (v, H), types["output"])
    for i in range(nl):
        p = f"blk.{i}."
        f32(p + "attn_norm.weight", (H,), 1.0)
        f32(p + "ffn_norm.weight", (H,), 1.0)
        projs = {"attn_q": (qd, H), "attn_k": (kvd, H), "attn_v": (kvd, H), "attn_output": (H, qd)}
        if "num_experts" in kw:
            e, mi = kw["num_experts"], kw["moe_intermediate_size"]
            projs.update(ffn_gate_exps=(e, mi, H), ffn_up_exps=(e, mi, H),
                         ffn_down_exps=(e, H, mi))
            f32(p + "ffn_gate_inp.weight", (e, H), std=0.3)
        else:
            i_ = kw["intermediate_size"]
            projs.update(ffn_gate=(i_, H), ffn_up=(i_, H), ffn_down=(H, i_))
        for stem, shape in projs.items():
            quant(p + stem + ".weight", shape, types[stem])
        if arch == "qwen2":
            for t, n in (("q", qd), ("k", kvd), ("v", kvd)):
                f32(p + f"attn_{t}.bias", (n,))
        if arch in ("qwen3", "qwen3moe"):
            for t in "qk":
                f32(p + f"attn_{t}_norm.weight", (kw["head_dim"],), 1.0)
    w.write()


def _equal(a, b, where="weights"):
    """Port weights ``a`` equal carried weights ``b``: the same tree, dense
    leaves bit for bit, quantized leaves plane for plane (codes, scales,
    biases, group size, packing, code bits)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, QTensor):
        assert isinstance(b, QTensor), where
        assert (a.group_size, a.packed, a.code_bits) == (b.group_size, b.packed, b.code_bits), where
        for f in ("data", "scale", "bias"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f"{where}.{f}"
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), f"{where}.{f}"
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a is None and b is None, where


def _run_both(jcfg, jw, cfg, tw, n_decode):
    """f32 logits of a prefill chunk and ``n_decode`` decode steps from both
    packages (JAX ``backend="xla"``) → [(jax, port)]."""
    jc = JaxCache.create(jcfg, 17, BS, dtype=jnp.float32)
    tc = PagedKVCache.create(cfg, 17, BS, dtype=torch.float32, device="cpu")
    bt, steps = _schedule(n_decode=n_decode)
    out = []
    for ids, pos, slots, kv_lens, last in steps:
        jl, jc = jax_forward(
            jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(kv_lens), block_size=BS, backend="xla",
            compute_dtype=jnp.float32, last_indices=None if last is None else jnp.asarray(last))
        tl, tc = forward_paged(
            tw, cfg, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), tc,
            torch.from_numpy(bt), torch.from_numpy(slots), torch.from_numpy(kv_lens),
            block_size=BS, compute_dtype=torch.float32,
            last_indices=None if last is None else torch.from_numpy(last).long())
        out.append((np.asarray(jl, np.float32), tl.numpy()))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf")
    out = {}
    for i, arch in enumerate(ARCHS):
        out[arch] = str(d / f"tiny-{arch}.gguf")
        _write(out[arch], arch, seed=i)
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gguf_matches_jax(files, arch):
    """The port's weights equal JAX's carried across, bit for bit; the q
    rows in the order each arch needs; the types land where they should;
    f32 ``forward_paged`` agrees (module docstring)."""
    jcfg, jw, _ = jax_load_gguf(files[arch], dtype=jnp.float32)
    cfg, tw, _ = load_gguf_model(files[arch], dtype=torch.float32, device="cpu")
    assert cfg.arch == jcfg.arch == arch
    for f in ("vocab_size", "hidden_size", "num_heads", "num_kv_heads", "head_dim", "qk_norm",
              "num_experts", "num_experts_per_tok", "moe_intermediate_size", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    _equal(tw, from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32))
    # llama.cpp's q/k row permutation undone for llama files only: the q rows
    # are the file's rows in HF order for llama, in the file's own order else
    content = GGUFContent.open(files[arch])
    raw = content.tensor_bytes("blk.0.attn_q.weight")
    info = content.tensor_info("blk.0.attn_q.weight")
    file_rows = QTensor.from_gguf_raw(raw, info.ggml_type, tuple(info.shape),
                                      device="cpu").dequantize()
    del raw  # a view of the file's map: closed only once no view is left
    content.close()
    n, hd = file_rows.shape[0], cfg.head_dim
    perm = torch.arange(n).reshape(cfg.num_heads, hd // 2, 2).transpose(1, 2).reshape(n)
    want = file_rows[perm] if arch == "llama" else file_rows
    assert torch.equal(tw["layers"][0]["wq"].dequantize(), want)
    lw = tw["layers"][1]
    assert ("wq_bias" in lw) == (arch == "qwen2") and ("q_norm" in lw) == cfg.qk_norm
    assert (tw["lm_head"] is None) == (arch == "qwen2")  # a file without output.weight: tied
    if arch == "qwen3moe":
        gate, down = lw["experts"]["gate"], lw["experts"]["down"]
        assert gate.packed and gate.group_size == 16 and gate.num_banks == 8
        assert down.signed and down.group_size == 16 and down.bias is None
    reset_counts()
    # each JAX step re-traces its layer scan (~1 s); decode runs where the
    # port's decode differs from its prefill: qwen3moe's 16-row grouped
    # tiles (the qwen2 engine run below decodes the dense archs' path)
    for jl, tl in _run_both(jcfg, jw, cfg, tw, n_decode=int(arch == "qwen3moe")):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2 * np.abs(jl).max())
        assert np.corrcoef(tl.ravel(), jl.ravel())[0, 1] > 0.9999
    assert not any(k in COUNTS for k in ("w4_matmul", "w8_matmul"))  # CPU: plain versions
    if arch in ("llama", "qwen3moe"):
        assert COUNTS["w4_matmul_g16_plain" if arch == "llama" else "w4_matmul_g16_g_plain"] > 0


@pytest.mark.parametrize("arch", ["qwen2"])
def test_engine_greedy_matches_jax(files, arch):
    """f32 engines on the file's weights, through ``load_pipeline``: a
    20-token and a 13-token prompt in one prefill chunk, 4 greedy tokens
    each, the same in both packages."""
    jcfg, jw, _ = jax_load_gguf(files[arch], dtype=jnp.float32)
    pipe = load_pipeline(files[arch], dtype=torch.float32, device="cpu")
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=32)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg), compute_dtype=torch.float32,
                device="cpu", **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=4)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=4)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 4 for s in ts)


def test_qwen_tokenizer_and_chat_prompt_match_jax(files):
    """The Qwen file's tokenizer (gpt2 BPE, ``pre`` qwen2, control tokens)
    and chat template through ``load_pipeline`` give JAX's ids, decodes and
    prompt."""
    pipe = load_pipeline(files["qwen2"], device="cpu")
    _, _, jmd = jax_load_gguf(files["qwen2"])
    jt = jax_tokenizer(jmd)
    for text in ["hello world", "<|im_start|>user\nthe quick brown fox!<|im_end|>\n",
                 "unseen zebra 123 ÿ"]:
        ids = pipe.tokenizer.encode(text)
        assert ids == jt.encode(text)
        assert pipe.tokenizer.decode(ids) == jt.decode(ids)
    assert pipe.tokenizer.eos_ids == jt.eos_ids and pipe.tokenizer.add_bos == jt.add_bos
    msgs = [{"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": "hello world"}]
    jct = jax_resolve_template(gguf_metadata=jmd, arch="qwen2")
    want = jct.render(msgs, add_generation_prompt=True)
    assert pipe.chat_template.render(msgs, add_generation_prompt=True) == want
    assert want.endswith("<|im_start|>assistant\n")
    assert pipe.tokenizer.encode(want) == jt.encode(want)


@pytest.mark.parametrize("arch", ["gemma2", "gemma3", "qwen2moe", "granite", "mamba"])
def test_refused_by_name(tmp_path, arch):
    """gemma2/gemma3 (no softcap or scale keys read; gemma's 1 added
    twice), qwen2moe (no shared expert), granite (no multipliers) and an
    unknown arch are refused by name, before any tensor is read."""
    w = GGUFWriter(str(tmp_path / "x.gguf"))
    for key, val in (("block_count", 1), ("context_length", 64), ("embedding_length", 8),
                     ("feed_forward_length", 16), ("attention.head_count", 1),
                     ("attention.head_count_kv", 1)):
        w.add_metadata(f"{arch}.{key}", np.uint32(val))
    w.add_metadata("general.architecture", arch)
    w.add_tensor("token_embd.weight", np.zeros((4, 8), np.float32))
    w.write()
    reason = {"gemma2": "softcap", "gemma3": "scale", "qwen2moe": "shared expert",
              "granite": "multipliers", "mamba": "served: llama, mistral, qwen2, qwen3, qwen3moe"}[arch]
    with pytest.raises(NotImplementedError, match=f"'{arch}'.*{reason}"):
        load_gguf_model(str(tmp_path / "x.gguf"), device="cpu")
    with pytest.raises(NotImplementedError, match=arch):
        load_pipeline(str(tmp_path / "x.gguf"), device="cpu")
