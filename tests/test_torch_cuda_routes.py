"""Constrained decoding and several models on one card (marked ``cuda``;
they skip where there is no GPU):

    python -m pytest tests/test_torch_cuda_routes.py -q -m cuda --noconftest

A tiny Llama-geometry Q4_K GGUF (:func:`write_tiny_gguf`: 2 layers, hidden
512, 4 query heads of 128 on 2 KV heads, a byte-level BPE tokenizer of 320
ids) served through the kernels:

* JSON- and regex-constrained requests beside a DRY and a plain one give
  the same tokens with the decode step captured in CUDA graphs as with it
  run eagerly (the constraint-bias rows written in place between replays),
  and every constrained output stays inside its recognizer;
* a second engine whose split state would have to grow while the first
  one's graphs hold it is refused; once those graphs are gone it builds;
* two engines on the card stepping on two threads at once give the greedy
  tokens each gives alone (their steps take turns on the device's lock);
* ``Engine.embed`` between steps, with graphs alive, equals ``embed`` on the
  same padded batch;
* ``ModelRegistry.load`` then ``unload`` gives the device memory back
  (``memory_allocated`` within 1 % of its value before the load).

The file imports no JAX (the card's machine is not promised to have it).
"""

import gc
import threading

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.embeddings import embed
from mistralrs_tpu_torch.engine.decode_step import DecodeStep
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.drawn import draw_blocks
from mistralrs_tpu_torch.gguf.writer import GGUFWriter
from mistralrs_tpu_torch.grammar import JsonConstraint, RegexConstraint
from mistralrs_tpu_torch.models.llama import fuse_projections
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.serving.registry import ModelRegistry

pytestmark = pytest.mark.cuda

CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
          "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")
REGEX = r"[a-z]{2,6}( [a-z]{2,6}){2,4}"


def write_tiny_gguf(path, seed: int = 0, hidden: int = 512, inter: int = 1024) -> None:
    """A 2-layer Llama-geometry GGUF: Q4_K projections and embedding, a Q6_K
    head, ``hidden / 128`` query heads of 128 on half as many KV heads, and
    a byte-level BPE tokenizer of the 256 byte symbols, 3 special tokens and
    unused ones up to 320 ids (no merges), with a ChatML template."""
    byte_syms = ([chr(c) for c in range(33, 127)] + [chr(c) for c in range(161, 173)]
                 + [chr(c) for c in range(174, 256)])
    tokens = byte_syms + [chr(256 + i) for i in range(256 - len(byte_syms))]
    tokens += ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    tokens += [f"<|unused_{i}|>" for i in range(320 - len(tokens))]
    nh, v = hidden // 128, len(tokens)
    gen = torch.Generator().manual_seed(seed)
    w = GGUFWriter(path)
    w.add_metadata("general.architecture", "llama")
    for key, val in dict(block_count=2, context_length=1024, embedding_length=hidden,
                         feed_forward_length=inter, vocab_size=v,
                         **{"attention.head_count": nh, "attention.head_count_kv": nh // 2,
                            "rope.dimension_count": 128}).items():
        w.add_metadata(f"llama.{key}", np.uint32(val))
    w.add_metadata("llama.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    w.add_metadata("llama.rope.freq_base", np.float32(5e5))
    w.add_metadata("tokenizer.ggml.model", "gpt2")
    w.add_metadata("tokenizer.ggml.tokens", tokens)
    w.add_metadata("tokenizer.ggml.merges", [])
    w.add_metadata("tokenizer.ggml.token_type", [1] * 256 + [3] * (v - 256))
    w.add_metadata("tokenizer.ggml.eos_token_id", np.uint32(tokens.index("<|im_end|>")))
    w.add_metadata("tokenizer.ggml.bos_token_id", np.uint32(tokens.index("<|endoftext|>")))
    w.add_metadata("tokenizer.ggml.add_bos_token", False)
    w.add_metadata("tokenizer.chat_template", CHATML)

    def quant(name, shape, t, std=0.05):  # blocks drawn as they are stored
        w.add_raw_tensor(name, draw_blocks(t, shape, gen, "cpu", std=std), shape, t)

    quant("token_embd.weight", (v, hidden), GGMLType.Q4_K, std=0.5)
    w.add_tensor("output_norm.weight", torch.ones(hidden))
    quant("output.weight", (v, hidden), GGMLType.Q6_K)
    kv = hidden // 2
    for i in range(2):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", torch.ones(hidden))
        w.add_tensor(p + "ffn_norm.weight", torch.ones(hidden))
        for name, shape in (("attn_q", (hidden, hidden)), ("attn_k", (kv, hidden)),
                            ("attn_v", (kv, hidden)), ("attn_output", (hidden, hidden)),
                            ("ffn_gate", (inter, hidden)), ("ffn_up", (inter, hidden)),
                            ("ffn_down", (hidden, inter))):
            quant(p + name + ".weight", shape, GGMLType.Q4_K)
    w.write()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def gguf(tmp_path):
    path = tmp_path / "tiny.gguf"
    write_tiny_gguf(path)
    return path


def _engine(path, dev, **kw):
    pipe = load_pipeline(str(path), device=dev)
    opts = dict(num_blocks=64, block_size=16, max_batch=4, max_model_len=512,
                prefill_chunk=64)
    opts.update(kw)
    return Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg),
                  tokenizer=pipe.tokenizer, device=dev, **opts), pipe


def _eager_launch(self, width):
    """``DecodeStep.launch`` with the step function run uncaptured."""
    self.upload(width)
    out = self.compute(width)
    for host, d in zip(self._results, out):
        host.copy_(d, non_blocking=True)
    self._done.record()
    return out


def _requests(engine, tok):
    prompts = [tok.encode(f"prompt number {i} " * (i + 2)) for i in range(4)]
    params = [SamplingParams(temperature=0.0, max_tokens=24, constraint="json_object"),
              SamplingParams(temperature=0.7, seed=5, max_tokens=24, constraint="regex:" + REGEX),
              SamplingParams(temperature=0.0, max_tokens=24, dry_multiplier=0.8),
              SamplingParams(temperature=0.0, max_tokens=24)]
    seqs = [engine.add_request(p, sp) for p, sp in zip(prompts, params)]
    engine.run_to_completion()
    return [s.generated_ids for s in seqs], seqs


def test_constrained_graph_matches_eager(dev, gguf, monkeypatch):
    engine, pipe = _engine(gguf, dev)
    _cuda.reset_counts()
    graph_out, seqs = _requests(engine, pipe.tokenizer)
    assert engine.decode_step._graphs, "no graph was captured"
    assert _cuda.COUNTS["w4_matmul"] > 0 and _cuda.COUNTS["paged_decode"] > 0
    assert not any(k.endswith("_plain") and v for k, v in _cuda.COUNTS.items())
    builder = engine._get_mask_builder()
    for seq, cons in zip(seqs[:2], (JsonConstraint("object"), RegexConstraint(REGEX))):
        st = cons.initial()
        for t in seq.generated_ids:
            st = builder.advance_with_token(cons, st, t)
            assert st is not None
        assert seq.stop_reason.value != "stop_token" or cons.is_complete(st)
    engine.close()
    monkeypatch.setattr(DecodeStep, "launch", _eager_launch)
    eager, pipe = _engine(gguf, dev)
    eager_out, _ = _requests(eager, pipe.tokenizer)
    assert not eager.decode_step._graphs
    assert eager_out == graph_out
    eager.close()


def test_second_engine_refused_while_graphs_hold_split_state(dev, gguf):
    first, pipe = _engine(gguf, dev)
    first.add_request(pipe.tokenizer.encode("warm up"), SamplingParams(temperature=0.0,
                                                                       max_tokens=4))
    first.run_to_completion()
    assert first.decode_step._graphs
    with pytest.raises(RuntimeError, match="while a CUDA graph uses it"):
        _engine(gguf, dev, max_batch=1024)
    first.close()
    gc.collect()
    wide, _ = _engine(gguf, dev, max_batch=1024)  # no graph holds the buffers now
    wide.close()


def test_two_engines_on_two_threads_match_alone(dev, gguf):
    a, pipe = _engine(gguf, dev)
    b, _ = _engine(gguf, dev, max_batch=2)
    tok = pipe.tokenizer
    prompts = [tok.encode(f"thread test {i} " * 3) for i in range(3)]

    def run(engine, ps):
        seqs = [engine.add_request(p, SamplingParams(temperature=0.0, max_tokens=16))
                for p in ps]
        engine.run_to_completion()
        return [s.generated_ids for s in seqs]

    alone = (run(a, prompts), run(b, prompts[::-1]))
    out = [None, None]
    threads = [threading.Thread(target=lambda i=i, e=e, ps=ps: out.__setitem__(i, run(e, ps)))
               for i, (e, ps) in enumerate(((a, prompts), (b, prompts[::-1])))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert tuple(out) == alone
    a.close()
    b.close()


def test_embed_between_steps_with_graphs_alive(dev, gguf):
    engine, pipe = _engine(gguf, dev)
    engine.add_request(pipe.tokenizer.encode("capture"), SamplingParams(temperature=0.0,
                                                                        max_tokens=4))
    engine.run_to_completion()
    assert engine.decode_step._graphs
    batches = [[5, 6, 7], list(range(10, 40))]
    got = engine.embed(batches)
    want = embed(engine.weights, engine.cfg, batches, max_len=32, device=dev)
    np.testing.assert_array_equal(got, want)
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-3)
    engine.close()


def test_unload_gives_memory_back(dev, gguf):
    _cuda.reserve(dev, 1 << 22, 1 << 12)  # the split state outlives engines: size it first
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    reg = ModelRegistry()  # loads go to the card
    inst = reg.load("tiny", str(gguf), engine_options=dict(num_blocks=64, block_size=16,
                                                            max_batch=4, max_model_len=512))
    done = threading.Event()
    seq = inst.submit(inst.tokenizer.encode("hello"), SamplingParams(temperature=0.0,
                                                                     max_tokens=8),
                      lambda toks, fin: fin and done.set())
    assert done.wait(120) and len(seq.generated_ids) == 8
    held = torch.cuda.memory_allocated(dev)
    assert held > before
    del inst, seq
    assert reg.unload("tiny") and not reg.unload("tiny")
    gc.collect()
    after = torch.cuda.memory_allocated(dev)
    # against what the model held, not the whole card's allocation
    assert abs(after - before) <= 0.01 * (held - before), (before, held, after)
