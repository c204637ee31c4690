"""The port's ``forward_paged`` against the JAX package's
(``mistralrs_tpu.models.llama.forward_paged(backend="xla")``) on a tiny
2-layer llama, with weights carried across by ``convert.from_jax_params``,
and the Q4_K path through a tiny GGUF loaded by each package's loader.

Both run a chunked prefill (two rows, one padded) and then decode steps over
the same paged layout; the port takes its plain kernel versions on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.convert import convert_hf_to_gguf
from mistralrs_tpu.gguf.constants import GGMLType
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.gguf_loader import load_gguf_model as jax_load_gguf
from mistralrs_tpu.models.llama import fuse_projections as jax_fuse
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.quant.qtensor import QTensor as JaxQTensor
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.models.llama import forward_paged, fuse_projections
from mistralrs_tpu_torch.pipeline import load_pipeline

BS = 8  # block size
CFG_KW = dict(
    arch="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=256, rope_theta=500000.0,
)


def jax_to_numpy(w):
    """JAX weight tree → numpy leaves (QTensor → plane dict)."""
    if isinstance(w, JaxQTensor):
        return {"data": np.asarray(w.data), "scale": np.asarray(w.scale),
                "bias": None if w.bias is None else np.asarray(w.bias),
                "group_size": w.group_size, "packed": w.packed,
                "code_bits": w.code_bits}
    if isinstance(w, dict):
        return {k: jax_to_numpy(v) for k, v in w.items()}
    return None if w is None else np.asarray(w)


def _schedule(b_rows=2, prompt=(21, 13), n_decode=3):
    """Paged layout: per-row block tables and the steps to run
    [(ids, positions, slots, kv_lens, last_idx)], prefill then decode."""
    rng = np.random.default_rng(7)
    w = 8
    bt = rng.permutation(b_rows * w).astype(np.int32).reshape(b_rows, w)
    total = [p + n_decode for p in prompt]
    toks = [rng.integers(0, 256, n).tolist() for n in total]

    def slot(b, p):
        return int(bt[b, p // BS] * BS + p % BS)

    t = max(prompt) + 3  # padded chunk
    ids = np.zeros((b_rows, t), np.int32)
    pos = np.zeros((b_rows, t), np.int32)
    slots = np.full((b_rows, t), -1, np.int32)
    for b in range(b_rows):
        ids[b, :prompt[b]] = toks[b][:prompt[b]]
        pos[b, :prompt[b]] = np.arange(prompt[b])
        slots[b, :prompt[b]] = [slot(b, p) for p in range(prompt[b])]
    steps = [(ids, pos, slots, np.asarray(prompt, np.int32),
              np.asarray(prompt, np.int32) - 1)]
    for d in range(n_decode):
        p = np.asarray(prompt) + d
        ids = np.asarray([[toks[b][p[b]]] for b in range(b_rows)], np.int32)
        steps.append((ids, p[:, None].astype(np.int32),
                      np.asarray([[slot(b, p[b])] for b in range(b_rows)], np.int32),
                      (p + 1).astype(np.int32), None))
    return bt, steps


def _run_both(jcfg, jw, tcfg, tw, compute, num_blocks=17):
    """Logits of every step from both packages → list of (jax, port)."""
    jdt = jnp.float32 if compute == torch.float32 else jnp.bfloat16
    jc = JaxCache.create(jcfg, num_blocks, BS, dtype=jdt)
    tc = PagedKVCache.create(tcfg, num_blocks, BS, dtype=compute, device="cpu")
    bt, steps = _schedule()
    out = []
    for ids, pos, slots, kv_lens, last in steps:
        jl, jc = jax_forward(
            jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(kv_lens), block_size=BS, backend="xla",
            compute_dtype=jdt, last_indices=None if last is None else jnp.asarray(last),
        )
        tl, tc = forward_paged(
            tw, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), tc,
            torch.from_numpy(bt), torch.from_numpy(slots), torch.from_numpy(kv_lens),
            block_size=BS, compute_dtype=compute,
            last_indices=None if last is None else torch.from_numpy(last).long(),
        )
        out.append((np.asarray(jl, np.float32), tl.numpy()))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_dense_f32_matches_jax(fused):
    """f32 weights and compute: the two packages agree to f32 rounding
    (rtol/atol 1e-4 on logits of magnitude ~0.1)."""
    jcfg = JaxConfig(**CFG_KW)
    jw = jax_init(jcfg, seed=1, dtype=jnp.float32, scale=0.1)
    tw = from_jax_params(jax_to_numpy(jw), ModelConfig(**CFG_KW), device="cpu",
                         dtype=torch.float32)
    if fused:
        jw, tw = jax_fuse(jw, jcfg), fuse_projections(tw, ModelConfig(**CFG_KW))
        assert "wqkv" in tw["layers"][0] and "wgateup" in tw["layers"][0]
    for jl, tl in _run_both(jcfg, jw, ModelConfig(**CFG_KW), tw, torch.float32):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_dense_bf16_matches_jax():
    """bf16 weights and compute: agreement within bf16 rounding of the
    activations (atol 0.05 on logits of magnitude ~1, rows correlated >0.999)."""
    jcfg = JaxConfig(**CFG_KW)
    jw = jax_init(jcfg, seed=2, dtype=jnp.bfloat16, scale=0.1)
    tw = from_jax_params(jax_to_numpy(jw), ModelConfig(**CFG_KW), device="cpu",
                         dtype=torch.bfloat16)
    for jl, tl in _run_both(jcfg, jw, ModelConfig(**CFG_KW), tw, torch.bfloat16):
        np.testing.assert_allclose(tl, jl, atol=5e-2)
        for a, b in zip(jl.reshape(-1, jl.shape[-1]), tl.reshape(-1, tl.shape[-1])):
            assert np.corrcoef(a, b)[0, 1] > 0.999


def _write_q4k_gguf(path, kw, seed=3):
    """A tiny llama GGUF from random HF-layout weights, Q4_K layers and a
    Q8_0 embedding and head (the JAX package's converter)."""
    rng = np.random.default_rng(seed)
    h, i, v = kw["hidden_size"], kw["intermediate_size"], kw["vocab_size"]
    qd, kvd = kw["num_heads"] * kw["head_dim"], kw["num_kv_heads"] * kw["head_dim"]

    def a(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    sd = {"model.embed_tokens.weight": a(v, h), "model.norm.weight": 1 + a(h),
          "lm_head.weight": a(v, h)}
    for li in range(kw["num_layers"]):
        p = f"model.layers.{li}."
        sd.update({
            p + "input_layernorm.weight": 1 + a(h),
            p + "post_attention_layernorm.weight": 1 + a(h),
            p + "self_attn.q_proj.weight": a(qd, h), p + "self_attn.k_proj.weight": a(kvd, h),
            p + "self_attn.v_proj.weight": a(kvd, h), p + "self_attn.o_proj.weight": a(h, qd),
            p + "mlp.gate_proj.weight": a(i, h), p + "mlp.up_proj.weight": a(i, h),
            p + "mlp.down_proj.weight": a(h, i),
        })
    convert_hf_to_gguf(sd, JaxConfig(**kw), path, quant=GGMLType.Q4_K)


GGUF_KW = dict(CFG_KW, hidden_size=256, intermediate_size=512, head_dim=64)


def test_q4k_gguf_both_loaders(tmp_path):
    """A Q4_K GGUF (Q8_0 embedding and head, written by the JAX package's
    converter) loads through each package's loader to the same planes, and
    the logits agree (f32 compute; weights dequantize to bf16 in both:
    rtol/atol 1e-3)."""
    path = str(tmp_path / "tiny-q4k.gguf")
    _write_q4k_gguf(path, GGUF_KW)
    h = GGUF_KW["hidden_size"]
    jcfg2, jw, _ = jax_load_gguf(path)
    tcfg, tw, _ = load_gguf_model(path, device="cpu")
    assert tcfg.hidden_size == h and tcfg.num_layers == 2
    wq = tw["layers"][1]["wq"]
    assert wq.packed and wq.bias is not None and wq.group_size == 32
    np.testing.assert_array_equal(wq.data.numpy(), np.asarray(jw["layers"]["wq"].data[1]))
    np.testing.assert_array_equal(wq.scale.numpy(), np.asarray(jw["layers"]["wq"].scale[1]))
    assert tw["lm_head"].data.dtype == torch.int8  # Q8_0 head
    for jl, tl in _run_both(jcfg2, jw, tcfg, tw, torch.float32):
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)


def test_load_pipeline_gguf_on_cpu(tmp_path):
    """load_pipeline on a .gguf path with device="cpu": config, planar
    weights on the CPU and the llama fallback chat template (the file has
    no tokenizer metadata, so there is no tokenizer)."""
    path = str(tmp_path / "tiny-pipe.gguf")
    _write_q4k_gguf(path, GGUF_KW, seed=4)
    pipe = load_pipeline(path, device="cpu")
    assert pipe.model_id == "tiny-pipe" and pipe.tokenizer is None
    assert pipe.cfg.num_kv_heads == 2 and pipe.cfg.vocab_size == 256
    assert pipe.weights["layers"][0]["down"].data.device.type == "cpu"
    text = pipe.chat_template.render([{"role": "user", "content": "hi"}])
    assert "<|start_header_id|>user<|end_header_id|>" in text
    with pytest.raises(NotImplementedError):
        load_pipeline(str(tmp_path), device="cpu")  # HF directories but DeepSeek's: not ported
