"""Llama-family decoder over the paged KV cache and over the contiguous
caches (counterpart of ``mistralrs_tpu/models/llama.py``: ``forward_paged``
at :903, ``forward`` at :687 with ``_layer_step`` at :530, the dense MLP,
the Mixtral-style mixture of experts (``_moe_mlp`` at :272) and gpt-oss's
(``_gpt_oss_experts`` at :496), plus ``fuse_projections``,
``layer_windows`` and ``init_random_weights``). Both forwards run one
layer body (:class:`_Decoder`), into which each plugs its attention: the
fused paged kernels, or ``ops/attention.py::sdpa`` over
``kv/contiguous.py``'s caches.

Weights are a plain dictionary. Per-layer weights are a LIST of dictionaries
(one per layer) and the decoder is a Python loop over it, where the JAX
package stacks them and runs ``lax.scan``. A projection is a dense
``[out, in]`` tensor or a planar :class:`QTensor`:

    {"embed": [V, H], "final_norm": [H], "lm_head": [V, H] | None (tied),
     "layers": [{"attn_norm", "ffn_norm", "wq", "wk", "wv" | "wqkv", "wo",
                 "gate", "up" | "wgateup", "down",
                 "post_attn_norm", "post_ffn_norm" (Gemma-2, optional),
                 "wq_bias", "wk_bias", "wv_bias" | "wqkv_bias", "wo_bias",
                 "q_norm", "k_norm" (qwen3, qwen3moe: [head_dim]),
                 "sinks" (gpt-oss, optional)}, ...]}

The gemma family (JAX ``forward_paged`` :940-950, :1064-1067, :1195-1208,
:1324-1325) scales the embedding by ``sqrt(hidden)`` cast to the compute
dtype, applies its norms as ``1 + w`` (``rms_norm_gemma``) and the post
norms where the layer has them; ``cfg.hidden_act`` picks the MLP's
activation; each layer's window (``layer_windows(cfg)``, a Python int, so a
captured step keeps it) and ``cfg.attn_logit_softcap`` go to both attention
kernels, and
``cfg.logit_softcap`` caps the f32 logits.

An MoE layer holds ``"router"`` (dense ``[E, H]``) and ``"experts"``
(``{"gate", "up" | "gateup", "down"}``, each a ``[E, out, in]`` bank: a
:class:`QTensor` with a bank axis or a dense tensor) in place of the dense
MLP's ``gate``/``up``/``down``. Quantized banks (GPTQ and AWQ expert banks
at groups 64 and 128 too), and dense banks of 16 experts or more
(Qwen3-MoE's 128, Qwen1.5-MoE's 60), run the grouped kernels
(``ops/moe_grouped.py::moe_grouped_mlp``); smaller dense banks run every
expert on every token, as the JAX package does. qwen2moe's layers add
``"shared_expert"`` (a dense MLP's ``{"gate", "up" | "wgateup", "down"}``,
plain or planar) and ``"shared_expert_gate"`` (dense ``[1, H]``): the
shared expert's output, times ``sigmoid`` of the gate's f32 logit, joins
the routed experts' (JAX ``_moe_mlp``, :450-456). gpt-oss's layers add
``"router_bias"`` ``[E]`` and hold ``"experts"`` as ``{"gateup" [E, 2I, H]
(the gate rows, then the up rows), "gateup_bias" [E, 2I], "down" [E, H,
I], "down_bias" [E, H]}`` bf16 banks, run by the dense grouped kernel
(``ops/moe_grouped.py::gpt_oss_grouped_mlp``); its attention has q/k/v/o
biases and a sink per query head (``"sinks"``, f32 ``[n_q]``, read in
place by both attention kernels), and YaRN's attention factor multiplies
cos and sin (JAX ``_rope_sets``, :671-684).

Qwen3's q/k norm (``cfg.qk_norm``, JAX ``forward_paged`` :1082-1084) is
an RMSNorm of each head's q and k over head_dim, after the projections and
before RoPE (Gemma-3's in the gemma form, ``1 + w``; hunyuan's after RoPE,
``cfg.qk_norm_after_rope``, JAX :1094-1096); Qwen2's q/k/v biases are the
attention biases above.

The Llama-family variants (phi2, phi3, starcoder2, stablelm, cohere,
granite, glm, glm4, smollm3, hunyuan; JAX ``forward_paged`` :903-1326):
LayerNorm with optional biases in place of RMSNorm (``cfg.norm_type``;
``attn_norm_bias``, ``ffn_norm_bias``, ``final_norm_bias``), partial and
interleaved rotary (``partial_rotary_factor``, ``rope_interleaved``),
NoPE layers (``layer_rope_flags``: no rotation at all), the gateless MLP
``down(act(up x))`` and the MLP biases ``gate_bias``, ``up_bias`` and
``down_bias``, the parallel residual (``h + attn + mlp``, both read the
one normed input; no ffn norm), granite's ``residual_multiplier`` on both
branches and ``embedding_multiplier``, the logits divided by
``logits_scaling`` (cohere's ``1 / logit_scale``), ``lm_head_bias`` (phi2,
added to the f32 logits), glm4's sandwich norms (``post_attn_norm``,
``post_ffn_norm``) and ``attn_scale`` (granite's
``attention_multiplier``) as both kernels' scale.

Gemma-3 has two rope sets (JAX ``_rope_sets``, :671-684): the global one of
``rope_theta`` with ``rope_scaling`` (linear, factor 8, on the 4B-27B
models), and a local one of ``rope_local_theta`` without scaling, which
each sliding layer takes (JAX :551-556); the choice is per layer and
static, as the window is.

Attention runs through the fused paged kernels (``ops/paged_attention.py``):
the decode kernel for one token per row, the prefill kernel otherwise; both
write the step's K/V into the pools in place (quantized as they are written
when the cache holds int8 or fp8 pools, ``kv/paged.py``). The routers of ``mixtral``,
of ``llama`` with experts (how GGUF Mixtral files arrive), of ``qwen3moe``
(top-k of the logits, softmax over the k, renormalised with
``norm_topk_prob``), of ``qwen2moe`` (softmax over all experts, top-k,
renormalised only with ``norm_topk_prob``) and of ``gpt_oss`` (top-k of
the biased logits, softmax over the k, no renormalisation) are ported;
other routers (hunyuan_moe, glm4moe, phimoe), shared experts outside
qwen2moe, dense first-k layers, expert parallelism, LoRA and M-RoPE are not
yet and raise ``NotImplementedError`` (:func:`check_supported`), as does a
gated MLP with biases (``mlp_bias``), which the reference loads unbiased.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kv.contiguous import (
    HybridKVCache,
    KVCache,
    RotatingKVCache,
    advance_ring,
    hybrid_layer_maps,
    write_kv,
    write_kv_ring,
)
from ..kv.paged import PagedKVCache
from ..ops.attention import sdpa
from ..ops.moe_grouped import gpt_oss_grouped_mlp, moe_grouped_mlp
from ..ops.norms import layer_norm, rms_norm, rms_norm_gemma
from ..ops.paged_attention import (
    decode_counters,
    decode_plan,
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from ..ops.quant_matmul import split_need_tree
from ..ops.rope import apply_rope, rope_cos_sin, rope_frequencies, yarn_attention_factor
from ..quant.linear import embedding_lookup, linear
from ..quant.fp8 import Fp8Tensor
from ..quant.qtensor import QTensor
from .config import ModelConfig, layer_rope_flags, layer_windows


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_new": functools.partial(F.gelu, approximate="tanh"),
    "gelu_pytorch_tanh": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}

# archs whose MoE router is ported: mixtral (softmax over all experts, top-k,
# renormalise), qwen2moe (the same, renormalised only with norm_topk_prob),
# llama with experts and qwen3moe (top-k of the logits, softmax over k,
# renormalised with norm_topk_prob) and gpt_oss (the same on logits plus the
# router bias, never renormalised)
_MOE_ARCHS = ("llama", "mixtral", "qwen2moe", "qwen3moe", "gpt_oss")
# dense banks of at least this many experts run the grouped kernels; the JAX
# package runs them through its _sparse_expert_combine (at most 64 tokens) or
# its every-expert scan, the same function up to f32 sum order
_GROUPED_MIN_E = 16


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for config features the port lacks."""
    moe = cfg.num_experts > 0
    unsupported = {
        f"mixture-of-experts router of arch {cfg.arch!r}": moe and cfg.arch not in _MOE_ARCHS,
        "top-k wider than the expert count": moe and not (
            0 < cfg.num_experts_per_tok <= cfg.num_experts),
        "shared expert outside qwen2moe": (bool(cfg.shared_expert_intermediate_size)
                                           and cfg.arch != "qwen2moe"),
        "dense first-k layers": bool(cfg.first_k_dense),
        "M-RoPE": bool(cfg.mrope_section),
        f"norm type {cfg.norm_type!r}": cfg.norm_type not in ("rmsnorm", "layernorm"),
        f"activation {cfg.hidden_act!r}": cfg.hidden_act not in ACTIVATIONS,
        "NoPE flags of another length than the layers": bool(cfg.no_rope_layers) and len(
            cfg.no_rope_layers) != cfg.num_layers,
        # the reference's loader maps no mlp.{gate,up,down}_proj.bias and runs
        # such a model unbiased (starcoder2's and phi2's gateless MLPs carry
        # their biases under other names, without this key)
        "biases of a gated MLP (mlp_bias)": cfg.mlp_bias,
    }
    missing = [name for name, on in unsupported.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def _maybe_norm(x: torch.Tensor, w: torch.Tensor, eps: float, gemma: bool, bias=None,
                norm_type: str = "rmsnorm") -> torch.Tensor:
    """The config's norm (JAX ``_maybe_norm``): LayerNorm with its optional
    bias, or RMSNorm (gemma's ``1 + w`` form)."""
    if norm_type == "layernorm":
        return layer_norm(x, w, bias, eps)
    return rms_norm_gemma(x, w, eps) if gemma else rms_norm(x, w, eps)


def _mlp(x: torch.Tensor, lw: dict, plain: bool, act=F.silu, return_hidden: bool = False):
    """Dense MLP (JAX ``_mlp``): gated, ``down(act(gate x) * up x)`` (``gate``
    and ``up`` or the fused ``wgateup``), or gateless, ``down(act(up x))``
    (starcoder2, phi2), each projection with its bias where the layer has
    one (``gate_bias``, ``up_bias``, ``down_bias``; a fused layer has none).
    ``return_hidden`` also returns down's input (the imatrix's ``down_in``)."""
    if "wgateup" in lw:
        gu = linear(x, lw["wgateup"], plain=plain)
        half = gu.shape[-1] // 2
        hidden = act(gu[..., :half]) * gu[..., half:]
    else:
        up = linear(x, lw["up"], lw.get("up_bias"), plain=plain)
        if "gate" in lw:
            hidden = act(linear(x, lw["gate"], lw.get("gate_bias"), plain=plain)) * up
        else:
            hidden = act(up)
    out = linear(hidden, lw["down"], lw.get("down_bias"), plain=plain)
    return (out, hidden) if return_hidden else out


def route(router_logits: torch.Tensor, cfg: ModelConfig):
    """Top-k routing from f32 router logits → ``(topw, topi)`` ``[..., k]``
    (JAX ``_moe_mlp``, :337-348). ``mixtral`` and ``qwen2moe``: softmax over
    all experts, top-k, renormalised (qwen2moe only with
    ``norm_topk_prob``: else the k weights sum to less than 1); ``llama``
    with experts and ``qwen3moe``: top-k of the logits, softmax over the k
    (renormalised with ``norm_topk_prob``, as JAX divides at :347-348;
    ``gpt_oss`` never). Mixtral's and llama's are the same function up to
    rounding."""
    k = cfg.num_experts_per_tok
    if cfg.arch in ("mixtral", "qwen2moe"):
        probs = torch.softmax(router_logits, dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)
        if cfg.arch == "mixtral" or cfg.norm_topk_prob:
            topw = topw / topw.sum(dim=-1, keepdim=True)
    else:
        topw, topi = torch.topk(router_logits, k, dim=-1)
        topw = torch.softmax(topw, dim=-1)
        if cfg.norm_topk_prob and cfg.arch != "gpt_oss":
            topw = topw / topw.sum(dim=-1, keepdim=True)
    return topw, topi


def _moe_mlp(x: torch.Tensor, lw: dict, cfg: ModelConfig, plain: bool = False,
             act=F.silu) -> torch.Tensor:
    """Mixture-of-experts MLP (JAX ``_moe_mlp``, ``models/llama.py:272``).

    A bank with any quantized leaf, or of at least ``_GROUPED_MIN_E`` dense
    experts (Qwen3-MoE's 128 bf16 experts: the dense grouped kernel), runs
    the grouped kernels
    (:func:`~mistralrs_tpu_torch.ops.moe_grouped.moe_grouped_mlp`); a
    smaller bank of dense leaves runs every expert on every token with a
    masked combine, as the JAX package does outside any Pallas kernel.
    qwen2moe's shared expert (JAX :450-456) then adds its MLP's output
    times ``sigmoid`` of the f32 logit of ``shared_expert_gate``, cast to
    that output's dtype, after the routed experts."""
    b, t, h = x.shape
    # router logits follow the JAX dtype path: linear in the compute dtype, then f32
    router_logits = linear(x, lw["router"], plain=plain).to(torch.float32)
    if "router_bias" in lw:  # gpt_oss
        router_logits = router_logits + lw["router_bias"].to(torch.float32)
    topw, topi = route(router_logits, cfg)
    experts = lw["experts"]
    if cfg.arch == "gpt_oss":
        out = gpt_oss_grouped_mlp(x.reshape(-1, h), experts, topw.reshape(b * t, -1),
                                  topi.reshape(b * t, -1), plain=plain).reshape(b, t, h)
    elif (cfg.num_experts >= _GROUPED_MIN_E
            or any(isinstance(v, QTensor) for v in experts.values())):
        out = moe_grouped_mlp(x.reshape(-1, h), experts, topw.reshape(b * t, -1),
                              topi.reshape(b * t, -1), act, plain=plain).reshape(b, t, h)
    else:
        full_w = torch.zeros((b, t, cfg.num_experts), dtype=torch.float32, device=x.device)
        full_w.scatter_add_(-1, topi, topw)
        out = torch.zeros_like(x)
        for e in range(cfg.num_experts):
            ew = {("wgateup" if key == "gateup" else key): w[e] for key, w in experts.items()}
            y = _mlp(x, ew, plain, act)
            out = out + y * full_w[..., e, None].to(y.dtype)
    if "shared_expert" in lw:  # qwen2moe
        shared = _mlp(x, lw["shared_expert"], plain, act)
        if "shared_expert_gate" in lw:
            g = torch.sigmoid(linear(x, lw["shared_expert_gate"], plain=plain).to(torch.float32))
            shared = shared * g.to(shared.dtype)
        out = out + shared
    return out


class _Decoder:
    """What every layer of one forward shares: the config's switches, the
    rope sets at this step's positions, the per-layer windows and RoPE
    flags, granite's residual multiplier (a 0-dim tensor in the compute
    dtype, as JAX casts it) and ``plain``."""

    def __init__(self, cfg: ModelConfig, positions: torch.Tensor, dtype, plain: bool):
        self.cfg, self.plain = cfg, plain
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.gemma = cfg.arch.startswith("gemma")
        self.windows = layer_windows(cfg).tolist()
        self.use_rope = layer_rope_flags(cfg).tolist()
        self.ropes = rope_sets(cfg, positions)
        self.rm = (None if not cfg.residual_multiplier
                   else torch.tensor(cfg.residual_multiplier, dtype=dtype))

    def norm(self, x, w, bias=None, norm_type="rmsnorm"):
        return _maybe_norm(x, w, self.cfg.rms_norm_eps, self.gemma, bias, norm_type)

    def layer(self, h: torch.Tensor, lw: dict, li: int, attend, moments=None) -> torch.Tensor:
        """One decoder layer (JAX ``_layer_step``, :530-668, and the layer
        loop of ``forward_paged``): norms, projections, q/k norms, RoPE,
        ``attend(li, q, k, v) -> [B, T, n_q, hd]`` (the paged kernels or the
        contiguous ``sdpa``), the MLP or the experts, and the residuals.
        ``moments`` (a dict of lists) collects the imatrix taps: Σx² in f32
        over batch and time of the normed input (``attn_in``), the attention
        output before ``wo`` (``o_in``), the FFN's normed input (``mlp_in``;
        the same x under a parallel residual) and the dense MLP's hidden
        (``down_in``; none on expert layers)."""
        cfg, plain, act = self.cfg, self.plain, self.act
        b, t, _ = h.shape
        x = self.norm(h, lw["attn_norm"], lw.get("attn_norm_bias"), cfg.norm_type)
        if "wqkv" in lw:
            qkv = linear(x, lw["wqkv"], lw.get("wqkv_bias"), plain=plain)
            q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        else:
            q = linear(x, lw["wq"], lw.get("wq_bias"), plain=plain)
            k = linear(x, lw["wk"], lw.get("wk_bias"), plain=plain)
            v = linear(x, lw["wv"], lw.get("wv_bias"), plain=plain)
        q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm and not cfg.qk_norm_after_rope:  # each head's q and k (qwen3)
            q = self.norm(q, lw["q_norm"])
            k = self.norm(k, lw["k_norm"])
        if self.use_rope[li]:  # a NoPE layer (smollm3) rotates nothing
            cos, sin = self.ropes[1] if self.windows[li] > 0 else self.ropes[0]  # sliding: local
            q = apply_rope(q, cos, sin, interleaved=cfg.rope_interleaved)
            k = apply_rope(k, cos, sin, interleaved=cfg.rope_interleaved)
        if cfg.qk_norm and cfg.qk_norm_after_rope:  # hunyuan
            q = self.norm(q, lw["q_norm"])
            k = self.norm(k, lw["k_norm"])
        attn = attend(li, q, k, v).reshape(b, t, cfg.q_dim).to(h.dtype)
        attn_out = linear(attn, lw["wo"], lw.get("wo_bias"), plain=plain)
        if moments is not None:
            moments["attn_in"].append(_sq(x))
            moments["o_in"].append(_sq(attn))
        if cfg.parallel_residual:  # phi2, cohere: the MLP reads the same normed x
            if moments is None:
                return h + attn_out + _mlp(x, lw, plain, act)
            mlp_out, hidden = _mlp(x, lw, plain, act, return_hidden=True)
            moments["mlp_in"].append(_sq(x))
            moments["down_in"].append(_sq(hidden))
            return h + attn_out + mlp_out
        rm = self.rm
        if "post_attn_norm" in lw:
            attn_out = self.norm(attn_out, lw["post_attn_norm"])
        h = h + (attn_out if rm is None else attn_out * rm)
        x = self.norm(h, lw["ffn_norm"], lw.get("ffn_norm_bias"), cfg.norm_type)
        hidden = None
        if "experts" in lw:
            mlp_out = _moe_mlp(x, lw, cfg, plain, act)
        elif moments is not None:
            mlp_out, hidden = _mlp(x, lw, plain, act, return_hidden=True)
        else:
            mlp_out = _mlp(x, lw, plain, act)
        if "post_ffn_norm" in lw:
            mlp_out = self.norm(mlp_out, lw["post_ffn_norm"])
        if moments is not None:
            moments["mlp_in"].append(_sq(x))
            if hidden is not None:
                moments["down_in"].append(_sq(hidden))
        return h + (mlp_out if rm is None else mlp_out * rm)


def _sq(a: torch.Tensor) -> torch.Tensor:
    """Σa² in f32 over the batch and time axes (an imatrix tap)."""
    return a.to(torch.float32).square().sum(dim=(0, 1))


def _embed(weights: dict, cfg: ModelConfig, input_ids: torch.Tensor, compute_dtype):
    """The token embedding in the compute dtype, times gemma's ``sqrt(hidden)``
    or granite's ``embedding_multiplier`` (each cast to the compute dtype
    first, as the JAX package casts it)."""
    h = embedding_lookup(input_ids, weights["embed"], dtype=compute_dtype)
    if cfg.arch.startswith("gemma"):
        h = h * torch.tensor(cfg.embedding_multiplier or cfg.hidden_size ** 0.5, dtype=h.dtype)
    elif cfg.embedding_multiplier:  # granite
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=h.dtype)
    return h


def _final_norm(weights: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return _maybe_norm(h, weights["final_norm"], cfg.rms_norm_eps, cfg.arch.startswith("gemma"),
                       weights.get("final_norm_bias"), cfg.norm_type)


def _head(weights: dict, cfg: ModelConfig, h: torch.Tensor, plain: bool) -> torch.Tensor:
    """f32 logits of the normed ``h``: the head (the embedding when tied),
    phi2's ``lm_head_bias``, the division by ``logits_scaling`` (granite;
    cohere's ``1 / logit_scale``) and the final softcap."""
    lm_head = weights.get("lm_head")
    if lm_head is None:
        lm_head = weights["embed"]
    logits = linear(h, lm_head, plain=plain).to(torch.float32)
    if weights.get("lm_head_bias") is not None:  # phi2
        logits = logits + weights["lm_head_bias"].to(torch.float32)
    if cfg.logits_scaling:
        logits = logits / cfg.logits_scaling
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward_paged(
    weights: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] logical position of each token
    cache: PagedKVCache,  # pools updated in place
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    slot_mapping: torch.Tensor,  # [B, T] physical slot per token (−1 → dropped)
    kv_lens: torch.Tensor,  # [B] valid KV length *after* this step's writes
    *,
    block_size: int,
    logits_last_only: bool = True,
    compute_dtype=torch.bfloat16,
    last_indices: Optional[torch.Tensor] = None,  # [B] per-row last VALID index
    plain: bool = False,
):
    """Decoder step over the paged KV cache (decode or chunked prefill).

    Returns ``(logits f32, cache)``; ``logits`` is ``[B, 1, V]`` with
    ``logits_last_only`` (each row's token at ``last_indices``, else the last
    one) and ``[B, T, V]`` otherwise. ``plain=True`` runs the plain PyTorch
    version of every kernel on any device (the card's smoke run compares)."""
    check_supported(cfg)
    b, t = input_ids.shape
    h = _embed(weights, cfg, input_ids, compute_dtype)
    dec = _Decoder(cfg, positions, h.dtype, plain)
    softcap = float(cfg.attn_logit_softcap or 0.0)
    attn_scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5
    i32 = dict(dtype=torch.int32, device=input_ids.device)
    block_tables = block_tables.to(**i32).contiguous()
    kv_lens = kv_lens.to(**i32).contiguous()
    slots = slot_mapping.to(**i32).reshape(b, t).contiguous()
    n_valid = (
        (last_indices.to(**i32) + 1) if last_indices is not None
        else torch.full((b,), t, **i32)
    )
    # the step's rows in the pools' dtype, or in the compute dtype for 1-byte
    # pools: the kernels quantize them as they write them
    kv_dtype = compute_dtype if cache.quantized else cache.k.dtype

    def attend(li, q, k, v):
        """The fused paged kernels: this step's K/V written into the pools."""
        k = k.to(kv_dtype)
        v = v.to(kv_dtype)
        scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale,
                      window=int(dec.windows[li]), softcap=softcap,
                      sinks=weights["layers"][li].get("sinks"))
        if t == 1:
            return paged_decode_attention_fused(
                q[:, 0].contiguous(), cache.k, cache.v, k[:, 0].contiguous(),
                v[:, 0].contiguous(), slots[:, 0].contiguous(), block_tables,
                kv_lens, li, block_size=block_size, scale=attn_scale, plain=plain, **scales,
            )[:, None]
        return paged_prefill_attention_fused(
            q.contiguous(), cache.k, cache.v, k.contiguous(), v.contiguous(),
            slots, block_tables, kv_lens, n_valid, li,
            block_size=block_size, scale=attn_scale, plain=plain, **scales,
        )

    for li, lw in enumerate(weights["layers"]):
        h = dec.layer(h, lw, li, attend)
    h = _final_norm(weights, cfg, h)
    if logits_last_only:
        if last_indices is not None:
            idx = last_indices.to(device=h.device, dtype=torch.long)
            h = h[torch.arange(b, device=h.device), idx][:, None]
        else:
            h = h[:, -1:]
    return _head(weights, cfg, h, plain), cache


def _host_starts(kv_start, b: int) -> list[int]:
    """Each row's write offset as a host int (a tensor is read once)."""
    vals = (kv_start.reshape(-1) if isinstance(kv_start, torch.Tensor)
            else np.asarray(kv_start).reshape(-1)).tolist()
    if len(vals) != b:
        raise ValueError(f"kv_start has {len(vals)} offsets for {b} rows")
    return [int(x) for x in vals]


# forward's arguments that the port refuses, each with the ROADMAP item that
# brings it
_REFUSED = {
    "input_embeds": "multimodal merged embeddings (ROADMAP Queue 1 item 12)",
    "rope_override": "M-RoPE tables (ROADMAP Queue 1 item 12)",
    "bidirectional": "block diffusion's bidirectional attention (ROADMAP Queue 1 item 13)",
    "tp_axis": "tensor parallelism (ROADMAP Queue 1 item 11)",
}


def forward(
    weights: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    cache,  # KVCache | RotatingKVCache | HybridKVCache, written in place
    kv_start,  # [B] tokens already in the cache (host ints, or a tensor read once)
    *,
    logits_last_only: bool = False,
    compute_dtype=torch.bfloat16,
    return_hidden: bool = False,
    collect_moments: bool = False,
    plain: bool = False,
    input_embeds=None,
    bidirectional: bool = False,
    rope_override=None,
    tp_axis=None,
):
    """Decoder over a contiguous KV cache (JAX ``forward``, :687-900):
    returns ``(logits [B, T or 1, V] f32, cache)``; with ``return_hidden``
    the final-norm hidden states ``[B, T, H]`` f32 in place of the logits;
    with ``collect_moments`` (a :class:`KVCache` only) also ``{tap: [L,
    dim] f32}``, the imatrix taps of :meth:`_Decoder.layer` stacked over the
    layers.

    Attention is ``ops/attention.py::sdpa``. A :class:`KVCache` (and a
    hybrid cache's full layers) takes the chunk at ``kv_start`` and attends
    over the buffer's first ``kv_start + T`` entries; a ring layer
    (:class:`RotatingKVCache`, a hybrid cache's sliding layers) attends over
    the ring as it was before this chunk together with the chunk itself,
    then writes the chunk (its last ``window`` rows), and ``slot_pos`` takes
    the chunk's positions after the last layer. The projections go through
    the W4/W8 kernels as in ``forward_paged``; the layer body is the same.

    Refused: a ring cache for a model with sinks (JAX's ring branch drops
    them, ROADMAP Queue 3 item 11), imatrix taps over a ring cache,
    ``layers_moe`` segments (glm4moe, ROADMAP Queue 1 item 5) and the
    arguments of :data:`_REFUSED`."""
    for name, value in (("input_embeds", input_embeds), ("rope_override", rope_override),
                        ("bidirectional", bidirectional or None), ("tp_axis", tp_axis)):
        if value is not None:
            raise NotImplementedError(f"forward({name}=...): {_REFUSED[name]} is not ported")
    if "layers_moe" in weights:
        raise NotImplementedError("forward: layers_moe segments (glm4moe's dense-prefix MoE, "
                                  "ROADMAP Queue 1 item 5) are not ported")
    check_supported(cfg)
    b, t = input_ids.shape
    layers = weights["layers"]
    ring = isinstance(cache, (RotatingKVCache, HybridKVCache))
    if not ring and not isinstance(cache, KVCache):
        raise TypeError(f"forward: unknown cache {type(cache).__name__}")
    if ring and any("sinks" in lw for lw in layers):
        raise NotImplementedError(
            f"{type(cache).__name__} for a model with attention sinks: the JAX ring branch "
            f"drops the sinks (ROADMAP Queue 3 item 11); use KVCache")
    if collect_moments and ring:
        raise NotImplementedError("imatrix taps (collect_moments) over a ring cache: use KVCache")
    starts = _host_starts(kv_start, b)
    h = _embed(weights, cfg, input_ids, compute_dtype)
    dev = h.device
    positions = positions.to(device=dev, dtype=torch.int64)
    dec = _Decoder(cfg, positions, h.dtype, plain)
    kv_len = torch.tensor([s + t for s in starts], dtype=torch.int64, device=dev)
    opts = dict(scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap)
    if ring:  # every ring layer reads the ring as it was before this chunk
        kv_pos = torch.cat([cache.slot_pos.to(torch.int64), positions], dim=1)
    kinds, pool = hybrid_layer_maps(cfg) if isinstance(cache, HybridKVCache) else (None, None)

    def attend(li, q, k, v):
        if isinstance(cache, RotatingKVCache) or (kinds is not None and kinds[li]):
            kc, vc = ((cache.k[li], cache.v[li]) if kinds is None
                      else (cache.k_win[pool[li]], cache.v_win[pool[li]]))
            k, v = k.to(kc.dtype), v.to(vc.dtype)
            out = sdpa(q, torch.cat([kc, k], dim=1), torch.cat([vc, v], dim=1),
                       q_positions=positions, sliding_window=dec.windows[li],
                       kv_positions=kv_pos, **opts)
            write_kv_ring(kc, k, starts, cache.window)
            write_kv_ring(vc, v, starts, cache.window)
            return out
        kc, vc = ((cache.k[li], cache.v[li]) if kinds is None
                  else (cache.k_full[pool[li]], cache.v_full[pool[li]]))
        write_kv(kc, k.to(kc.dtype), starts)
        write_kv(vc, v.to(vc.dtype), starts)
        return sdpa(q, kc, vc, q_positions=positions, kv_len=kv_len,
                    sliding_window=dec.windows[li], sinks=layers[li].get("sinks"), **opts)

    moments = {tap: [] for tap in ("attn_in", "o_in", "mlp_in", "down_in")} if collect_moments \
        else None
    for li, lw in enumerate(layers):
        h = dec.layer(h, lw, li, attend, moments)
    if ring:
        advance_ring(cache.slot_pos, starts, t, cache.window)
    h = _final_norm(weights, cfg, h)
    if return_hidden:
        return h.to(torch.float32), cache
    if logits_last_only:
        h = h[:, -1:]
    logits = _head(weights, cfg, h, plain)
    if collect_moments:
        return logits, cache, {tap: torch.stack(v) for tap, v in moments.items()
                               if len(v) == len(layers)}
    return logits, cache


def rope_sets(cfg: ModelConfig, positions: torch.Tensor):
    """``((cos, sin), (cos_local, sin_local))`` at ``positions``: a copy of
    JAX ``_rope_sets``. Each covers the rotated dims, ``int(head_dim *
    partial_rotary_factor)``. The global set takes ``rope_scaling`` (and
    YaRN's attention factor, folded into cos and sin as HF and JAX do); the
    local set, for sliding layers, is ``rope_local_theta``'s without
    scaling, or the global set itself where the config has no local base."""
    rot_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    inv = rope_frequencies(rot_dim, cfg.rope_theta, cfg.rope_scaling, device=positions.device)
    cos, sin = rope_cos_sin(positions, inv)
    mscale = yarn_attention_factor(cfg.rope_scaling)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    if cfg.rope_local_theta is None:
        return (cos, sin), (cos, sin)
    inv_l = rope_frequencies(rot_dim, cfg.rope_local_theta, None, device=positions.device)
    return (cos, sin), rope_cos_sin(positions, inv_l)


def kernel_workspace(weights: dict, cfg: ModelConfig, batch: int, rows, widths,
                     block_size: int, sms: int) -> tuple[int, int]:
    """``(f32 workspace values, int32 counters)`` of the kernels' split
    state (``ops/_cuda.py``) that a forward takes, from the kernels' plans
    (static shapes): the quantized projections at any row count of
    ``rows``, and the paged decode kernel over ``batch`` sequences at any
    block-table width of ``widths``, for each layer window the model has
    (a sliding layer's plan splits only its window's positions). The
    grouped MoE kernels never split K."""
    floats, counters = split_need_tree(weights, rows, sms)
    group = cfg.num_heads // cfg.num_kv_heads
    windows = set(layer_windows(cfg).tolist())
    for w in widths:
        for win in windows:
            plan = decode_plan(batch, cfg.num_kv_heads, group, w, block_size, sms, int(win))
            counters = max(counters, decode_counters(plan, batch, cfg.num_kv_heads))
    return floats, counters


# ---------------------------------------------------------------------------
# weight construction helpers
# ---------------------------------------------------------------------------


def _concat_n(ws):
    """Concat weights along out-features (dense [(E,) N, K], K-major
    QTensor [(E,) K, N], or blockwise FP8 of one block shape whose N are
    whole blocks); None when their kinds differ, a QTensor's rows are
    padded, or FP8 scales cannot be joined (per tensor, other blocks)."""
    if all(isinstance(w, Fp8Tensor) for w in ws):
        bs = ws[0].block_shape
        if bs is None or any(w.block_shape != bs or w.out_features % bs[0] for w in ws):
            return None
        return Fp8Tensor(torch.cat([w.data for w in ws], dim=-1),
                         torch.cat([w.scale for w in ws], dim=0), bs)
    if any(isinstance(w, Fp8Tensor) for w in ws):
        return None
    if all(isinstance(w, QTensor) for w in ws):
        first = ws[0]
        if not all(
            w.logical_n is None and w.packed == first.packed and w.group_size == first.group_size
            and w.code_bits == first.code_bits and w.data.dtype == first.data.dtype
            and (w.bias is None) == (first.bias is None)
            for w in ws
        ):
            return None
        return QTensor(
            data=torch.cat([w.data for w in ws], dim=-1),
            scale=torch.cat([w.scale for w in ws], dim=-1),
            bias=None if first.bias is None else torch.cat([w.bias for w in ws], dim=-1),
            group_size=first.group_size, packed=first.packed,
            code_bits=first.code_bits, ggml_type=first.ggml_type,
        )
    if any(isinstance(w, QTensor) for w in ws):
        return None
    return torch.cat(ws, dim=-2)


def _fuse(d: dict, parts: tuple[str, ...], fused_key: str) -> dict:
    """``d`` with ``parts`` merged into ``fused_key`` where their kinds match."""
    if all(p in d for p in parts):
        fused = _concat_n([d[p] for p in parts])
        if fused is not None:
            d = {k: v for k, v in d.items() if k not in parts}
            d[fused_key] = fused
    return d


def fuse_projections(weights: dict, cfg: ModelConfig) -> dict:
    """Merge each layer's q/k/v into ``wqkv`` (their biases, where all three
    have one, into ``wqkv_bias``), gate/up into ``wgateup`` (the shared
    expert's too) and an expert bank's gate/up into ``gateup`` (fewer kernel
    launches per layer); parts
    that differ in kind, or of which only some have a bias, stay unfused, and
    so do a gate and an up with a bias (``wgateup`` carries none, as JAX
    ``fuse_projections`` fuses no biased gate/up) and a gateless MLP's up.

    Fuses in place: each entry of ``weights["layers"]`` is replaced by its
    fused layer as soon as that exists, so the unfused parts are released
    layer by layer (the peak is one layer's parts over the model) and the
    model holds no second copy afterwards. Returns ``weights``."""
    layers = weights["layers"]
    qkv, biases = ("wq", "wk", "wv"), ("wq_bias", "wk_bias", "wv_bias")
    for i, lw in enumerate(layers):
        lw = dict(lw)
        n_bias = sum(k in lw for k in biases)
        if n_bias in (0, 3):
            lw = _fuse(lw, qkv, "wqkv")
        if n_bias == 3 and "wqkv" in lw:
            lw["wqkv_bias"] = torch.cat([lw.pop(k) for k in biases])
        if "gate_bias" not in lw and "up_bias" not in lw:
            lw = _fuse(lw, ("gate", "up"), "wgateup")
        if "experts" in lw:
            lw["experts"] = _fuse(lw["experts"], ("gate", "up"), "gateup")
        if "shared_expert" in lw:
            lw["shared_expert"] = _fuse(lw["shared_expert"], ("gate", "up"), "wgateup")
        layers[i] = lw
    return weights


def init_random_weights(
    cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, scale: float = 0.02,
    device: DeviceLike = None,
) -> dict:
    """Random dense weights (testing) on ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``), drawn from numpy in the same order as
    ``mistralrs_tpu.models.llama.init_random_weights`` (the layer stacks,
    then the embedding and the head), so the two packages start from the
    same numbers; a q/k-norm config (qwen3, gemma3) gets ``q_norm``/``k_norm``
    of ones ``[head_dim]``, as the JAX function makes them (gemma3 applies
    them in the gemma form, ``1 + w``, as every gemma norm). An MoE config
    (mixtral, qwen2moe, qwen3moe) then draws, after those, the router ``[L,
    E, H]`` and the expert banks gate and up ``[L, E, I, H]``, down ``[L,
    E, H, I]`` (``I`` = ``moe_intermediate_size`` or the dense width), which
    replace the layers' dense MLP (the JAX function draws no experts), and a
    qwen2moe config after those its shared expert, gate and up ``[L, S,
    H]``, down ``[L, H, S]`` (``S`` = ``shared_expert_intermediate_size``),
    and its gate ``[L, 1, H]``. Like the JAX function it
    makes no post norms, and draws no gpt-oss layers (its expert banks,
    biases and sinks come from a checkpoint or the JAX package's weights)."""
    check_supported(cfg)
    if cfg.arch == "gpt_oss":
        raise NotImplementedError("init_random_weights draws no gpt-oss experts, biases or "
                                  "sinks")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def arr(*shape):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    stacked = {
        "wq": arr(L, cfg.q_dim, H), "wk": arr(L, cfg.kv_dim, H),
        "wv": arr(L, cfg.kv_dim, H), "wo": arr(L, H, cfg.q_dim),
        "gate": arr(L, I, H), "up": arr(L, I, H), "down": arr(L, H, I),
    }
    embed = arr(cfg.vocab_size, H)
    lm_head = None if cfg.tie_word_embeddings else arr(cfg.vocab_size, H)
    ones = torch.ones(H, dtype=dtype, device=dev)
    layers = [
        {"attn_norm": ones.clone(), "ffn_norm": ones.clone(),
         **{k: v[i].contiguous() for k, v in stacked.items()}}
        for i in range(L)
    ]
    if cfg.qk_norm:
        for lw in layers:
            lw["q_norm"] = torch.ones(cfg.head_dim, dtype=dtype, device=dev)
            lw["k_norm"] = torch.ones(cfg.head_dim, dtype=dtype, device=dev)
    if cfg.num_experts:
        e, mi = cfg.num_experts, cfg.moe_intermediate_size or I
        router = arr(L, e, H)
        banks = {"gate": arr(L, e, mi, H), "up": arr(L, e, mi, H), "down": arr(L, e, H, mi)}
        for i, lw in enumerate(layers):
            for key in ("gate", "up", "down"):
                del lw[key]
            lw["router"] = router[i].contiguous()
            lw["experts"] = {k: v[i].contiguous() for k, v in banks.items()}
        si = cfg.shared_expert_intermediate_size
        if cfg.arch == "qwen2moe" and si:
            shared = {"gate": arr(L, si, H), "up": arr(L, si, H), "down": arr(L, H, si)}
            gate = arr(L, 1, H)
            for i, lw in enumerate(layers):
                lw["shared_expert"] = {k: v[i].contiguous() for k, v in shared.items()}
                lw["shared_expert_gate"] = gate[i].contiguous()
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones.clone(),
        "lm_head": lm_head,
    }
