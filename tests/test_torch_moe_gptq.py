"""qwen2moe and GPTQ/AWQ expert banks in the port, on the CPU, held against
the JAX package on inputs drawn with numpy from a seed.

* The qwen2moe router (softmax over all experts, top-k, renormalised only
  with ``norm_topk_prob``) against the combine weights JAX ``_moe_mlp``
  applies, with ``norm_topk_prob`` false and true (its MLP replaced by one
  that returns the expert's one-hot, so its output is those weights).
* ``_moe_mlp`` with the gated shared expert against JAX ``_moe_mlp`` (f32,
  1e-5): a dense bank of 4 experts (both packages' masked combine) and of
  16 (the port's grouped route, JAX's sparse combine).
* ``quant_matmul_grouped_plain`` over GPTQ banks at groups 64, 128 and K,
  4 and 8 bits, against JAX ``quant_matmul_grouped(backend="xla")`` (f32
  dequant: 1e-5 of the largest output), and one small case each of the JAX
  W4 and W8 grouped Pallas kernels at group 128 in interpret mode (bf16:
  1e-2 of the largest).
* Tiny HF directories written with the port's safetensors writer: qwen2moe
  in bf16 (16 experts top-4, shared expert, q/k/v biases), qwen2moe as
  GPTQ-Int4 (hidden 256, so gate/up pack split-half at group 128, and a
  ``moe_intermediate_size`` of 384, so down stays one byte a code as
  Qwen1.5-MoE's does), and Mixtral as AWQ. Both loaders give equal weights
  (planes bit for bit), and ``forward_paged``'s f32 logits at every prefill
  chunk and a decode step agree with JAX's (``backend="xla"``): within 1e-4
  in bf16 (f32 sums in another order), within 1e-2 of the largest for the
  quantized directories, whose grouped products both packages take on
  bf16-rounded expert inputs, so a last-bit f32 difference from the layers
  before can move one rounding (measured: 1.2e-3 for the GPTQ qwen2moe,
  1.4e-3 for the AWQ Mixtral; 6.7e-7 and 2.2e-6 with both packages'
  dequant patched to f32, so no more than roundings part them). One engine's
  greedy tokens equal the JAX engine's on the GPTQ qwen2moe.
* Configs: Qwen1.5-MoE-A2.7B's ``config.json`` gives equal configs in both
  packages, and a bare ``model_type: "qwen2_moe"`` the same arch in both.
* ``kernel_workspace`` against the wrappers' launches at Qwen1.5-MoE's
  shapes (meta tensors, a fake kernel library): the shared expert's and
  attention's W4 matrices need split state, the grouped wide forms none.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models import llama as jax_llama
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.config import config_from_hf as jax_config_from_hf
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.ops.moe_grouped import build_groups as jax_build_groups
from mistralrs_tpu.ops.quant_matmul import quant_matmul_grouped as jax_qmm_g
from mistralrs_tpu.quant import gptq_awq as jax_ga
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine, decode_widths, forward_rows
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models import llama as tll
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.llama import _moe_mlp, forward_paged, fuse_projections, route
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import build_groups
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant import gptq_awq
from mistralrs_tpu_torch.quant.qtensor import QTensor

from test_torch_decode_step import _matmul_call, _recorded_split_state
from test_torch_deepseek import write_safetensors
from test_torch_gptq_awq import _t, _weights_equal, draw_layer
from test_torch_llama import jax_to_numpy
from test_torch_qwen import _steps


# ---------------------------------------------------------------------------
# the router and the gated shared expert
# ---------------------------------------------------------------------------

def _qwen2moe_cfgs(**kw):
    base = dict(arch="qwen2moe", vocab_size=64, hidden_size=16, intermediate_size=24,
                num_layers=1, num_heads=2, num_kv_heads=2, head_dim=8,
                max_position_embeddings=64, num_experts=8, num_experts_per_tok=4,
                moe_intermediate_size=8, shared_expert_intermediate_size=24)
    base.update(kw)
    return JaxConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("norm", [False, True], ids=["norm_topk_false", "norm_topk_true"])
def test_router_matches_jax_moe_mlp(monkeypatch, norm):
    """JAX ``_moe_mlp`` on 8 dense experts (its masked combine) with its
    MLP replaced by one that returns expert e's one-hot: its output's first
    8 columns are the combine weights it scattered from its router. The
    port's ``route`` gives the same choices and weights (1e-6); without
    ``norm_topk_prob`` they sum to at most 1, here to well under it on some
    token."""
    jcfg, cfg = _qwen2moe_cfgs(norm_topk_prob=norm)
    e, h = cfg.num_experts, cfg.hidden_size
    rng = np.random.default_rng(20 + norm)
    x = rng.standard_normal((2, 5, h)).astype(np.float32)
    router = rng.standard_normal((e, h)).astype(np.float32)
    onehot = np.eye(h, dtype=np.float32)[:e, :, None]  # down [E, H, 1]: expert e's one-hot
    experts = {"gate": jnp.zeros((e, 1, h)), "up": jnp.zeros((e, 1, h)),
               "down": jnp.asarray(onehot)}
    monkeypatch.setattr(jax_llama, "_mlp", lambda x_, ew, *a, **k: jnp.broadcast_to(
        ew["down"][:, 0], x_.shape))
    full_w = np.asarray(jax_llama._moe_mlp(
        jnp.asarray(x), {"router": jnp.asarray(router), "experts": experts}, jcfg,
        jax.nn.silu, "xla"))[..., :e]
    logits = torch.from_numpy(x) @ torch.from_numpy(router).T
    topw, topi = route(logits, cfg)
    got = torch.zeros((2, 5, e)).scatter_add_(-1, topi, topw).numpy()
    np.testing.assert_array_equal(got > 0, full_w > 0)
    np.testing.assert_allclose(got, full_w, rtol=1e-6, atol=1e-7)
    sums = topw.sum(-1).numpy()
    if norm:
        np.testing.assert_allclose(sums, 1.0, rtol=1e-6)
    else:
        assert sums.max() <= 1.0 + 1e-6 and sums.min() < 0.99


@pytest.mark.parametrize("e", [4, 16], ids=["masked_combine", "grouped_route"])
def test_moe_mlp_with_shared_expert_matches_jax(e):
    """``_moe_mlp`` with the gated shared expert (f32, 1e-5): 4 dense
    experts run the masked combine in both packages, 16 the port's grouped
    route (the dense grouped kernel's plain version) against JAX's sparse
    combine; the shared expert's output times ``sigmoid`` of its gate's
    logit (which must move the output: the ungated sum differs)."""
    jcfg, cfg = _qwen2moe_cfgs(num_experts=e, hidden_size=32, moe_intermediate_size=16)
    h, mi, si = 32, 16, 24
    rng = np.random.default_rng(30 + e)

    def w(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    lw = {"router": w(e, h), "experts": {"gate": w(e, mi, h), "up": w(e, mi, h),
                                         "down": w(e, h, mi)},
          "shared_expert": {"gate": w(si, h), "up": w(si, h), "down": w(h, si)},
          "shared_expert_gate": w(1, h)}
    x = rng.standard_normal((1, 6, h)).astype(np.float32)
    ref = np.asarray(jax_llama._moe_mlp(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, lw),
                                        jcfg, jax.nn.silu, "xla"))
    tw = jax.tree_util.tree_map(torch.from_numpy, lw)
    reset_counts()
    got = _moe_mlp(torch.from_numpy(x), tw, cfg).numpy()
    assert (COUNTS["dense_matmul_g_plain"] == 3) == (e == 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ungated = _moe_mlp(torch.from_numpy(x), {k: v for k, v in tw.items()
                                             if k != "shared_expert_gate"}, cfg).numpy()
    assert np.abs(ungated - got).max() > 0.1 * np.abs(got).max()


def test_init_random_weights_draws_the_shared_expert():
    """The port's init on a qwen2moe config: the leaves the JAX function
    draws are equal to its (the same numpy stream), then the router and
    the banks, then the shared expert ``[S, H]``/``[H, S]`` and its gate
    ``[1, H]``; ``forward_paged`` runs on them."""
    jcfg, cfg = _qwen2moe_cfgs(num_layers=2)
    jw = jax_llama.init_random_weights(jcfg, seed=5, dtype=jnp.float32)
    tw = tll.init_random_weights(cfg, seed=5, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tw["embed"].numpy(), np.asarray(jw["embed"]))
    np.testing.assert_array_equal(tw["layers"][1]["wq"].numpy(), np.asarray(jw["layers"]["wq"][1]))
    lw = tw["layers"][1]
    si, h = cfg.shared_expert_intermediate_size, cfg.hidden_size
    assert {k: tuple(v.shape) for k, v in lw["shared_expert"].items()} == {
        "gate": (si, h), "up": (si, h), "down": (h, si)}
    assert lw["shared_expert_gate"].shape == (1, h) and lw["router"].shape == (8, h)
    cache = PagedKVCache.create(cfg, 4, 8, dtype=torch.float32, device="cpu")
    ids = torch.arange(6)[None] % cfg.vocab_size
    logits, _ = forward_paged(fuse_projections(tw, cfg), cfg, ids, torch.arange(6)[None], cache,
                              torch.arange(4, dtype=torch.int32)[None], torch.arange(6)[None],
                              torch.tensor([6]), block_size=8, compute_dtype=torch.float32)
    assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the grouped plain versions over GPTQ banks
# ---------------------------------------------------------------------------

def _gptq_banks(rng, e, k, n, group, bits):
    """``e`` experts drawn as GPTQ layers and decoded by each package, then
    stacked: (JAX bank, port bank)."""
    layers = [draw_layer(rng, k, n, group, bits, std=1 / np.sqrt(k)) for _ in range(e)]
    jq = [jax_ga.gptq_to_qtensor(*lay, bits=bits) for lay in layers]
    tq = [gptq_awq.gptq_to_qtensor(*map(_t, lay), bits=bits) for lay in layers]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jq), QTensor.stack(tq)


def _grouped_rows(topi, topw, e, tm, k, seed):
    x = np.random.default_rng(seed).standard_normal((topi.shape[0], k)).astype(np.float32)
    st, dest, _, tiles, mp = jax_build_groups(jnp.asarray(topi), jnp.asarray(topw), e, tm)
    xs = jnp.zeros((mp, k), jnp.float32).at[dest].set(jnp.asarray(x)[st])
    t_st, t_dest, _, t_tiles, n_used, t_mp = build_groups(
        torch.from_numpy(topi), torch.from_numpy(topw), e, tm)
    txs = torch.zeros((t_mp, k))
    txs[t_dest] = torch.from_numpy(x)[t_st]
    return (xs, tiles), (txs, t_tiles, n_used)


# bits, K, group: 4-bit at 64 and 128 pack split-half (W4); 4-bit per-column
# and 8-bit keep a byte a code (W8, unsigned with a bias plane)
GROUPED_CASES = {"w4_g64": (4, 256, 64), "w4_g128": (4, 256, 128),
                 "w4_gK_one_byte": (4, 384, 384), "w8_g64": (8, 256, 64),
                 "w8_g128": (8, 384, 128), "w8_gK": (8, 384, 384)}


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_plain_matches_xla(case):
    """4 experts, a ragged routing of 12 tokens with expert 1 empty, 16-row
    tiles: the plain grouped version against JAX's XLA path (f32 dequant,
    1e-5 of the largest output), counted under the wide grouped name."""
    bits, k, group = GROUPED_CASES[case]
    e, n, tm = 4, 64, 16
    rng = np.random.default_rng(40 + len(case))
    jb, tb = _gptq_banks(rng, e, k, n, group, bits)
    assert tb.num_banks == e and tb.packed == (bits == 4 and (k // 2) % group == 0)
    topi = rng.choice([0, 2, 3], (12, 2)).astype(np.int32)
    topw = np.ones((12, 2), np.float32)
    (xs, tiles), (txs, t_tiles, n_used) = _grouped_rows(topi, topw, e, tm, k, seed=7)
    ref = np.asarray(jax_qmm_g(xs, jb, tiles, tm=tm, backend="xla",
                               dequant_dtype=jnp.float32))
    reset_counts()
    got = qm.quant_matmul_grouped(txs, tb, t_tiles, tm=tm, n_used_tiles=n_used,
                                  compute_dtype=torch.float32).numpy()
    name = ("w4_matmul" if tb.packed else "w8_matmul") + "_wide_g_plain"
    assert dict(COUNTS) == {name: 1}
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bits,k", [(4, 256), (8, 384)], ids=["w4_g128", "w8_g128"])
def test_grouped_plain_matches_pallas_interpret(bits, k):
    """The JAX W4 / W8 grouped Pallas kernels at group 128 in interpret
    mode, 2 experts, 16-row tiles, bf16 (1e-2 of the largest output: the
    JAX W4 kernel adds the bias outside the bf16 weight)."""
    e, n, tm = 2, 128, 16
    rng = np.random.default_rng(50 + bits)
    jb, tb = _gptq_banks(rng, e, k, n, 128, bits)
    topi = rng.integers(0, e, (10, 1)).astype(np.int32)
    (xs, tiles), (txs, t_tiles, n_used) = _grouped_rows(
        topi, np.ones((10, 1), np.float32), e, tm, k, seed=8)
    ref = np.asarray(jax_qmm_g(xs.astype(jnp.bfloat16), jb, tiles, tm=tm, backend="pallas",
                               interpret=True), np.float32)
    got = qm.quant_matmul_grouped(txs.to(torch.bfloat16), tb, t_tiles, tm=tm,
                                  n_used_tiles=n_used).float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())


def test_qtensor_stack():
    """``QTensor.stack``: expert e of the bank is matrix e, plane for plane;
    matrices of another group size are refused."""
    rng = np.random.default_rng(60)
    qts = [gptq_awq.gptq_to_qtensor(*map(_t, draw_layer(rng, 256, 32, 128, 4)))
           for _ in range(3)]
    bank = QTensor.stack(qts)
    assert bank.num_banks == 3 and bank.shape == (3, 32, 256) and bank.packed
    for i, qt in enumerate(qts):
        b = bank.bank(i)
        assert all(torch.equal(getattr(b, f), getattr(qt, f)) for f in ("data", "scale", "bias"))
    other = gptq_awq.gptq_to_qtensor(*map(_t, draw_layer(rng, 256, 32, 64, 4)))
    with pytest.raises(ValueError, match="group 64"):
        QTensor.stack([qts[0], other])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

# Qwen/Qwen1.5-MoE-A2.7B-Chat-GPTQ-Int4's config.json
QWEN15_MOE_JSON = {
    "architectures": ["Qwen2MoeForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "decoder_sparse_step": 1, "eos_token_id": 151645,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 5632, "max_position_embeddings": 8192, "max_window_layers": 21,
    "model_type": "qwen2_moe", "moe_intermediate_size": 1408, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
    "num_hidden_layers": 24, "num_key_value_heads": 16, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.001,
    "shared_expert_intermediate_size": 5632, "sliding_window": 32768,
    "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936,
    "quantization_config": {"bits": 4, "group_size": 128, "damp_percent": 0.01,
                            "desc_act": False, "static_groups": False, "sym": True,
                            "true_sequential": True, "quant_method": "gptq"},
}


def test_config_matches_jax():
    """The published config: equal configs in both packages (qwen2moe,
    60 experts top-4 of 1408, a shared expert of 5632, no
    renormalisation); without ``architectures`` both packages take the
    ``model_type`` itself as the arch (``qwen2_moe``, whose router neither
    package has: the port refuses it)."""
    cfg, jcfg = config_from_hf(QWEN15_MOE_JSON), jax_config_from_hf(QWEN15_MOE_JSON)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.arch, cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size,
            cfg.shared_expert_intermediate_size, cfg.norm_topk_prob, cfg.num_kv_heads) == (
        "qwen2moe", 60, 4, 1408, 5632, False, 16)
    tll.check_supported(cfg)
    bare = {k: v for k, v in QWEN15_MOE_JSON.items() if k != "architectures"}
    assert config_from_hf(bare).arch == jax_config_from_hf(bare).arch == "qwen2_moe"
    with pytest.raises(NotImplementedError, match="qwen2_moe"):
        tll.check_supported(config_from_hf(bare))


# ---------------------------------------------------------------------------
# HF directories
# ---------------------------------------------------------------------------

GPTQ4 = {"quant_method": "gptq", "bits": 4, "group_size": 128, "sym": True, "desc_act": False}
AWQ4 = {"quant_method": "awq", "bits": 4, "group_size": 128, "zero_point": True,
        "version": "gemm"}
# kind: (architecture, quantization_config, hidden, heads (q = kv), head_dim,
# experts, top-k, expert width, shared expert width)
DIRS = {
    "qwen2moe_bf16": ("Qwen2MoeForCausalLM", None, 64, 4, 16, 16, 4, 32, 48),
    "qwen2moe_gptq4": ("Qwen2MoeForCausalLM", GPTQ4, 256, 4, 64, 4, 2, 384, 512),
    "mixtral_awq": ("MixtralForCausalLM", AWQ4, 256, 4, 64, 4, 2, 256, 0),
}
V, NL = 128, 2


def _write_dir(path, kind, seed):
    """The tiny checkpoint: norms 1 + N(0, 0.1^2), the router N(0, 0.5^2) and
    the shared-expert gate N(0, 0.3^2) in f16, q/k/v biases (qwen2moe) and the
    embedding and head in f16; every projection f16 of std 1/sqrt(K) in
    bf16 directories, else its GPTQ or AWQ triplet (as AutoGPTQ and AutoAWQ
    leave the routers and the shared-expert gate dense)."""
    arch, qc, h, nh, hd, e, top, mi, si = DIRS[kind]
    qwen = arch.startswith("Qwen")
    rng = np.random.default_rng(seed)
    cfg = {"architectures": [arch], "model_type": "qwen2_moe" if qwen else "mixtral",
           "vocab_size": V, "hidden_size": h, "intermediate_size": mi if not qwen else 2 * h,
           "num_hidden_layers": NL, "num_attention_heads": nh, "num_key_value_heads": nh,
           "head_dim": hd, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
           "max_position_embeddings": 128, "tie_word_embeddings": False,
           "num_experts_per_tok": top}
    if qwen:
        cfg.update(num_experts=e, moe_intermediate_size=mi, shared_expert_intermediate_size=si,
                   norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
                   use_sliding_window=False, sliding_window=32768)
    else:
        cfg.update(num_local_experts=e)
    if qc:
        cfg["quantization_config"] = qc

    def f16(*shape, s=0.1, base=0.0):
        return (base + s * rng.standard_normal(shape)).astype(np.float16)

    sd = {"model.embed_tokens.weight": f16(V, h, s=1.0), "model.norm.weight": f16(h, base=1),
          "lm_head.weight": f16(V, h, s=0.05)}

    def proj(name, n, k):
        if qc is None:
            sd[name + ".weight"] = f16(n, k, s=1 / np.sqrt(k))
            return
        qw, qz, s = draw_layer(rng, k, n, 128, 4, awq=qc["quant_method"] == "awq",
                               sym=qc.get("sym", False), std=1 / np.sqrt(k))
        sd.update({name + ".qweight": qw, name + ".qzeros": qz, name + ".scales": s})
        if qc["quant_method"] == "gptq":
            sd[name + ".g_idx"] = np.arange(k, dtype=np.int32) // 128

    for li in range(NL):
        p = f"model.layers.{li}."
        sd[p + "input_layernorm.weight"] = f16(h, base=1)
        sd[p + "post_attention_layernorm.weight"] = f16(h, base=1)
        for t in "qkvo":
            proj(f"{p}self_attn.{t}_proj", h if t == "o" else nh * hd, nh * hd if t == "o" else h)
            if qwen and t != "o":
                sd[f"{p}self_attn.{t}_proj.bias"] = f16(nh * hd)
        if qwen:
            sd[p + "mlp.gate.weight"] = f16(e, h, s=0.5)
            for j in range(e):
                for hf, (n, k) in (("gate_proj", (mi, h)), ("up_proj", (mi, h)),
                                   ("down_proj", (h, mi))):
                    proj(f"{p}mlp.experts.{j}.{hf}", n, k)
            for hf, (n, k) in (("gate_proj", (si, h)), ("up_proj", (si, h)),
                               ("down_proj", (h, si))):
                proj(f"{p}mlp.shared_expert.{hf}", n, k)
            sd[p + "mlp.shared_expert_gate.weight"] = f16(1, h, s=0.3)
        else:
            sd[p + "block_sparse_moe.gate.weight"] = f16(e, h, s=0.5)
            for j in range(e):
                for w, (n, k) in (("w1", (mi, h)), ("w3", (mi, h)), ("w2", (h, mi))):
                    proj(f"{p}block_sparse_moe.experts.{j}.{w}", n, k)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    write_safetensors(path / "model.safetensors", sd)
    return sd


@pytest.mark.parametrize("kind", list(DIRS))
def test_hf_dir_matches_jax(tmp_path, kind):
    """Both loaders on the tiny directory: the port's weights equal the JAX
    loader's carried across by ``from_jax_params`` (planes bit for bit: the
    W4 banks at group 128 and, for the GPTQ qwen2moe, the down bank that
    stays one byte a code); ``fuse_projections`` fuses each bank's gate and
    up (scale and bias planes along N) and the shared expert's; f32
    ``forward_paged`` logits at every prefill chunk (two for the GPTQ
    qwen2moe) and a decode step agree with JAX's (module docstring), on the
    grouped route."""
    _write_dir(tmp_path, kind, seed=len(kind))
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    cfg = pipe.cfg
    assert cfg.arch == jcfg.arch == ("mixtral" if kind.startswith("mixtral") else "qwen2moe")
    carried = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    _weights_equal(pipe.weights, carried)
    weights = fuse_projections(pipe.weights, cfg)
    lw = weights["layers"][0]
    gateup, down = lw["experts"]["gateup"], lw["experts"]["down"]
    e, mi, h = cfg.num_experts, cfg.moe_intermediate_size or cfg.intermediate_size, cfg.hidden_size
    assert gateup.shape == (e, 2 * mi, h) and down.shape == (e, h, mi)
    if kind == "qwen2moe_bf16":
        assert isinstance(gateup, torch.Tensor) and "wgateup" in lw["shared_expert"]
    else:
        for bank in (gateup, down):
            assert isinstance(bank, QTensor) and bank.group_size == 128
            qm._check_planes(bank)  # the CUDA wrapper takes the bank
        assert gateup.packed and down.packed == (kind == "mixtral_awq")
        if kind == "qwen2moe_gptq4":
            assert down.data.dtype == torch.uint8 and down.bias is not None
            assert isinstance(lw["shared_expert"]["wgateup"], QTensor)
    bs, w = 8, 8
    # a chunked prefill for the GPTQ qwen2moe, one chunk for the others, then
    # a decode step (each JAX forward re-traces its layer scan: ~1 s a step)
    chunk = 16 if kind == "qwen2moe_gptq4" else 24
    bt, steps = _steps((21, 18), chunk, 1, bs, w, seed=3)
    tc = PagedKVCache.create(cfg, 2 * w, bs, dtype=torch.float32, device="cpu")
    jc = JaxCache.create(jcfg, 2 * w, bs, dtype=jnp.float32)
    tol = 1e-4 if kind == "qwen2moe_bf16" else 1e-2
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
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max(),
                                   err_msg=f"{kind} step {i}")
    grouped = {"qwen2moe_bf16": {"dense_matmul_g_plain": 2},
               "qwen2moe_gptq4": {"w4_matmul_wide_g_plain": 1, "w8_matmul_wide_g_plain": 1},
               "mixtral_awq": {"w4_matmul_wide_g_plain": 2}}[kind]
    for name, per_layer in grouped.items():
        assert COUNTS[name] == per_layer * NL * len(steps), name


def test_engine_greedy_matches_jax(tmp_path):
    """f32 engines on the tiny GPTQ qwen2moe directory: a 12-token and a
    7-token prompt in 8-token chunks, 3 greedy tokens each; the port's
    decode step (uncaptured on the CPU) runs the router, the grouped W4/W8
    plain versions and the gated shared expert."""
    _write_dir(tmp_path, "qwen2moe_gptq4", seed=11)
    jcfg, jw, _ = jax_load_hf(tmp_path, dtype=jnp.float32)
    pipe = load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")
    ekw = dict(num_blocks=16, block_size=8, max_batch=2, prefill_chunk=8)
    je = JaxEngine(jcfg, jw, backend="xla", compute_dtype=jnp.float32, **ekw)
    te = Engine(pipe.cfg, fuse_projections(pipe.weights, pipe.cfg), compute_dtype=torch.float32,
                device="cpu", **ekw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, n).tolist() for n in (12, 7)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=3)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=3)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 3 for s in ts)


@pytest.mark.parametrize("case", ["router_triplet", "shared_gate_triplet", "gpt_oss_gptq"])
def test_refusals(tmp_path, case):
    """What stays unported raises ``NotImplementedError`` naming it: a
    router or shared-expert gate stored as a GPTQ triplet (N = 60 and N = 1
    fit no kernel), GPTQ on an MoE arch whose banks the loader does not read
    as triplets (gpt-oss's banks come pre-stacked)."""
    sd = _write_dir(tmp_path, "qwen2moe_gptq4", seed=1)
    if case == "gpt_oss_gptq":
        cfg = json.loads((tmp_path / "config.json").read_text())
        cfg.update(architectures=["GptOssForCausalLM"], model_type="gpt_oss", num_local_experts=8)
        (tmp_path / "config.json").write_text(json.dumps(cfg))
        match = "gpt_oss"
    else:
        name = "mlp.gate" if case == "router_triplet" else "mlp.shared_expert_gate"
        n = 8 if case == "router_triplet" else 1
        p = "model.layers.1."
        sd.pop(p + name + ".weight")
        qw, qz, s = draw_layer(np.random.default_rng(3), 256, 8, 128, 4)
        sd.update({p + name + ".qweight": qw[:, :n], p + name + ".qzeros": qz,
                   p + name + ".scales": s[:, :n]})
        write_safetensors(tmp_path / "model.safetensors", sd)
        match = name
    with pytest.raises(NotImplementedError, match=match):
        load_pipeline(str(tmp_path), dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# split state at Qwen1.5-MoE's shapes
# ---------------------------------------------------------------------------

def _meta_planes(n, k, packed, e=None):
    m = dict(device="meta")
    lead = () if e is None else (e,)
    return QTensor(torch.empty((*lead, k // 2 if packed else k, n), dtype=torch.uint8, **m),
                   torch.empty((*lead, k // 128, n), **m), torch.empty((*lead, k // 128, n), **m),
                   group_size=128, packed=packed, code_bits=4)


def _grouped_call(bank, mp, tm):
    m = dict(device="meta")
    x = torch.empty((mp, bank.in_features), dtype=torch.bfloat16, **m)
    out = torch.empty((mp, bank.out_features), dtype=torch.bfloat16, **m)
    tiles = torch.empty((mp // tm,), dtype=torch.int32, **m)
    n_used = torch.empty((1,), dtype=torch.int32, **m)
    fmt = qm._plane_format(bank)
    if bank.packed:
        return lambda: qm._w4_launch(x, bank, out, True, tiles, n_used, tm)
    return lambda: qm._w8_launch(x, bank, fmt, out, True, tiles, n_used, tm)


def test_kernel_workspace_covers_qwen15_moe(monkeypatch):
    """Qwen1.5-MoE-A2.7B's GPTQ-Int4 layer (q/k/v fused, o, the shared
    expert's fused gate/up and down: W4 at group 128; the expert banks: W4
    grouped gate/up and W8 grouped down) at every row count of an engine of
    8 slots and 256-token chunks: ``kernel_workspace`` is the largest split
    state any launch takes, and the grouped wide forms' launches, at both
    row tiles, take none."""
    cfg = config_from_hf(QWEN15_MOE_JSON)
    layer = {"wqkv": _meta_planes(6144, 2048, True), "wo": _meta_planes(2048, 2048, True),
             "shared_expert": {"wgateup": _meta_planes(11264, 2048, True),
                               "down": _meta_planes(2048, 5632, True)},
             "experts": {"gateup": _meta_planes(2816, 2048, True, e=60),
                         "down": _meta_planes(2048, 1408, False, e=60)}}
    rows = forward_rows(8, 256, 4)
    want = tll.kernel_workspace({"layers": [layer]}, cfg, 8, rows, decode_widths(1024, 16),
                                16, 132)
    dense = [layer["wqkv"], layer["wo"], *layer["shared_expert"].values()]
    got = _recorded_split_state(monkeypatch, [_matmul_call(qt, m) for qt in dense for m in rows])
    assert got[0] == want[0] > 0 and got[1] <= want[1]
    banks = layer["experts"].values()
    grouped = _recorded_split_state(monkeypatch, [_grouped_call(b, mp, tm) for b in banks
                                                  for mp, tm in ((32 * 16, 16), (2304, 64))])
    assert grouped == (0, 0)
