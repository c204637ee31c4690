"""The contiguous-cache path through the kernels on the card (marked
``cuda``; they skip where there is no GPU):

    python -m pytest tests/test_torch_cuda_contiguous.py -q -m cuda --noconftest

Tiny llama and Mixtral checkpoints drawn with numpy (hidden 256, 4 query
heads of 64 on 2 KV heads, 2 layers), quantized in situ to Q4_K on the card
(W4 projections and expert banks, a Q8_0 embedding and head):

* ``forward`` over ``KVCache``, ``RotatingKVCache`` (a window of 16) and
  ``HybridKVCache`` (a gemma2 config over the same tensors): a 40-token
  prefill of two rows and 3 decode steps through the kernels against the
  plain versions on the same weights in bf16, logits within 5e-2 of the
  largest (``chip_smoke.py`` phase 3's tolerance: bf16 activations through
  two layers; llama and Mixtral over ``KVCache`` came 1.0e-2 and 1.4e-2
  apart on an H100), W4 and W8 (and the grouped W4
  for Mixtral) launched and no plain version run in the kernel run;
* ``compute_perplexity``, ``embed``, ``generate`` and ``ImatrixCollector``
  on the card: perplexity within 1e-3 relative of the plain run's, the
  embeddings within 1e-2 of the largest, 8 greedy tokens, the imatrix taps
  of f32 weights equal to the CPU's within rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.embeddings import embed
from mistralrs_tpu_torch.generate import generate
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.imatrix import ImatrixCollector
from mistralrs_tpu_torch.kv.contiguous import HybridKVCache, KVCache, RotatingKVCache
from mistralrs_tpu_torch.models.config import config_from_hf
from mistralrs_tpu_torch.models.hf_loader import weights_from_state_dict
from mistralrs_tpu_torch.models.llama import forward, fuse_projections
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.perplexity import compute_perplexity

pytestmark = pytest.mark.cuda

H, V, NL, E = 256, 256, 2, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _checkpoint(moe: bool, seed: int = 0):
    """(HF config dict, f32 state dict) of a tiny llama or Mixtral."""
    rng = np.random.default_rng(seed)
    arch = "MixtralForCausalLM" if moe else "LlamaForCausalLM"
    cfg = {"architectures": [arch], "model_type": "mixtral" if moe else "llama",
           "vocab_size": V, "hidden_size": H, "intermediate_size": 512,
           "num_hidden_layers": NL, "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 64, "rms_norm_eps": 1e-6, "rope_theta": 1e4,
           "max_position_embeddings": 256, "tie_word_embeddings": False}
    if moe:
        cfg.update(num_local_experts=E, num_experts_per_tok=2)

    def w(*shape, s=None):
        s = shape[-1] ** -0.5 if s is None else s
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    sd = {"model.embed_tokens.weight": w(V, H, s=1.0), "model.norm.weight": 1 + w(H, s=0.1),
          "lm_head.weight": w(V, H)}
    for li in range(NL):
        p = f"model.layers.{li}."
        sd[p + "input_layernorm.weight"] = 1 + w(H, s=0.1)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(H, s=0.1)
        for t, (n, k) in {"q": (256, H), "k": (128, H), "v": (128, H), "o": (H, 256)}.items():
            sd[f"{p}self_attn.{t}_proj.weight"] = w(n, k)
        if moe:
            sd[p + "block_sparse_moe.gate.weight"] = w(E, H, s=0.5)
            for j in range(E):
                for name, (n, k) in (("w1", (512, H)), ("w3", (512, H)), ("w2", (H, 512))):
                    sd[f"{p}block_sparse_moe.experts.{j}.{name}.weight"] = w(n, k)
        else:
            for name, (n, k) in (("gate_proj", (512, H)), ("up_proj", (512, H)),
                                 ("down_proj", (H, 512))):
                sd[f"{p}mlp.{name}.weight"] = w(n, k)
    return cfg, sd


def _model(dev, moe=False):
    hf_cfg, sd = _checkpoint(moe)
    cfg = config_from_hf(hf_cfg)
    weights = weights_from_state_dict(sd, cfg, device=dev, isq=GGMLType.Q4_K)
    return cfg, fuse_projections(weights, cfg)


def _run(cfg, weights, cache_fn, dev, plain):
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, V, (2, 43), generator=gen, device=dev)
    cache = cache_fn()
    out = []
    logits, _ = forward(weights, cfg, ids[:, :40], torch.arange(40, device=dev)[None].expand(2, 40),
                        cache, [0, 0], plain=plain)
    out.append(logits)
    for p in range(40, 43):
        logits, _ = forward(weights, cfg, ids[:, p:p + 1], torch.full((2, 1), p, device=dev),
                            cache, [p, p], plain=plain)
        out.append(logits)
    torch.cuda.synchronize()
    return out


def _kernels_vs_plain(cfg, weights, cache_fn, dev, required):
    reset_counts()
    got = _run(cfg, weights, cache_fn, dev, plain=False)
    counts = dict(COUNTS)
    want = _run(cfg, weights, cache_fn, dev, plain=True)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 5e-2 * w.abs().max().item()
    missing = [k for k in required if not counts.get(k)]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    assert not missing and not plain_run, (missing, plain_run)


@pytest.mark.parametrize("cache_type", ["normal", "rotating", "hybrid"])
def test_forward_kernels_vs_plain(dev, cache_type):
    cfg, weights = _model(dev)
    if cache_type == "rotating":
        cfg = dataclasses.replace(cfg, sliding_window=16)
        cache_fn = lambda: RotatingKVCache.create(cfg, 2, device=dev)  # noqa: E731
    elif cache_type == "hybrid":
        cfg = dataclasses.replace(cfg, arch="gemma2", sliding_window=16,
                                  hidden_act="gelu_pytorch_tanh")
        cache_fn = lambda: HybridKVCache.create(cfg, 2, 64, device=dev)  # noqa: E731
    else:
        cache_fn = lambda: KVCache.create(cfg, 2, 64, device=dev)  # noqa: E731
    _kernels_vs_plain(cfg, weights, cache_fn, dev, ("w4_matmul", "w8_matmul"))


def test_mixtral_forward_kernels_vs_plain(dev):
    cfg, weights = _model(dev, moe=True)
    _kernels_vs_plain(cfg, weights, lambda: KVCache.create(cfg, 2, 64, device=dev), dev,
                      ("w4_matmul", "w4_matmul_g", "w8_matmul"))


def test_entry_points_on_the_card(dev):
    cfg, weights = _model(dev)
    toks = np.random.default_rng(2).integers(0, V, 5 * 32 + 3).tolist()
    reset_counts()
    got = compute_perplexity(weights, cfg, toks, window=32, batch_size=2)
    assert COUNTS["w4_matmul"] and not COUNTS["w4_matmul_plain"]
    want = compute_perplexity(weights, cfg, toks, window=32, batch_size=2, plain=True)
    assert got["tokens_scored"] == want["tokens_scored"] == 5 * 16
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-3)
    seqs = [toks[:7], toks[7:20], toks[20:24]]
    for pooling in ("last", "mean", "cls"):
        a = embed(weights, cfg, seqs, pooling=pooling)
        b = embed(weights, cfg, seqs, pooling=pooling, plain=True)
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
    out = generate(weights, cfg, toks[:9], max_new_tokens=8, stop_tokens=set())
    assert len(out) == 8 and all(0 <= t < V for t in out)


def test_imatrix_on_the_card_equals_the_cpu(dev):
    hf_cfg, sd = _checkpoint(False)
    cfg = config_from_hf(hf_cfg)
    ids = np.random.default_rng(3).integers(0, V, (2, 24))
    taps = []
    for d in (dev, torch.device("cpu")):
        weights = weights_from_state_dict(sd, cfg, dtype=torch.float32, device=d)
        coll = ImatrixCollector(cfg, device=d)
        coll.update(weights, ids)
        taps.append(coll.finalize())
    assert sorted(taps[0]) == ["attn_in", "down_in", "mlp_in", "o_in"]
    for tap in taps[1]:
        np.testing.assert_allclose(taps[0][tap], taps[1][tap], rtol=1e-4, atol=1e-9)
