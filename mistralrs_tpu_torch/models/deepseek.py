"""DeepSeek V2/V3 (and GLM-4-MoE-Lite): multi-head latent attention (MLA)
over a paged latent pool, and DeepSeek-MoE (counterpart of
``mistralrs_tpu/models/deepseek.py``: ``DeepseekConfig`` at :33,
``_mla_attention_paged`` at :348, ``deepseek_forward_paged`` at :474,
``make_paged_cache`` at :570, ``deepseek_weights_from_state_dict`` at :627).

Only the absorbed, engine-served form is ported: the pool holds one row
``[compressed latent ‖ roped k_pe]`` per token (``rank + rope`` wide, no
lane padding), ``W_uk`` is folded into the query and ``W_uv`` into the
output. At decode (one token per row) attention runs the MLA decode kernel
(``ops/mla_attention.py``); a prefill chunk runs the plain gather path,
which the JAX package also computes outside any Pallas kernel. A 1-byte
latent pool (``make_paged_cache(kv_quant="int8" | "fp8")``: one absmax
scale per (layer, slot) over the whole row, as JAX ``deepseek.py:435-449``)
takes the gather path at decode too, as the JAX package sends quantized
latent pools there (``:404``); the path is chosen from the pool, never as a
fallback from the kernel.

Weights are a plain dictionary with a LIST of per-layer dictionaries:

    {"embed": [V, H], "final_norm": [H], "lm_head": [V, H] | None (tied),
     "layers": [{"attn_norm", "ffn_norm", "q" | ("q_a", "q_a_norm", "q_b"),
                 "kv_a", "kv_a_norm", "w_uk" [nh, nope, rank],
                 "w_uv" [nh, v, rank], "o",
                 dense: "gate", "up", "down";
                 MoE: "router" [E, H], "router_bias" [E] (V3),
                      "experts": {"gateup" [E, 2I, H], "down" [E, H, I]},
                      "shared": {"gate", "up", "down"}}, ...]}

Routed experts run through the grouped MoE path
(``ops/moe_grouped.py::moe_grouped_mlp``, the dense grouped kernel on bf16
banks); the shared experts and the dense layers are plain ``linear`` calls,
as the JAX package leaves them to XLA. Like the JAX package, the port
ignores ``rope_scaling`` (plain RoPE, scale ``qk_head_dim ** -0.5``), so a
checkpoint with YaRN scaling (DeepSeek-V2-Lite has one) is not computed as
Hugging Face computes it; ``DeepseekConfig.from_hf`` logs a warning.
Speculative verify and LoRA are not ported.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kv.paged import CODE_DTYPES, quantize_rows
from ..ops.mla_attention import mla_blocks, mla_counters, mla_decode, mla_plan
from ..ops.moe_grouped import moe_grouped_mlp
from ..ops.norms import rms_norm
from ..ops.paged_attention import _softmax_attend
from ..ops.rope import rope_cos_sin, rope_frequencies
from ..ops.quant_matmul import split_need_tree
from ..quant.linear import embedding_lookup, linear
from .llama import _mlp as _dense_mlp

log = logging.getLogger(__name__)


@dataclass
class LatentCache:
    """The paged latent pool ``[L, S_total, rank + rope]`` (in the compute
    dtype, or 1-byte codes) and, for codes, one bf16 scale per (layer,
    slot), ``[L, S_total]``; updated in place."""

    pool: torch.Tensor
    scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.scale is not None


@dataclass
class DeepseekConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_layers: int
    num_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_rope_head_dim: int
    qk_nope_head_dim: int
    v_head_dim: int
    n_routed_experts: int
    num_experts_per_tok: int
    n_shared_experts: int
    first_k_dense_replace: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    routed_scaling_factor: float = 1.0
    scoring_func: str = "sigmoid"  # v3; "softmax" for v2
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    moe_layer_freq: int = 1  # only 1 (every layer past the dense prefix)
    eos_token_ids: tuple = ()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_rope_head_dim + self.qk_nope_head_dim

    @property
    def row_dim(self) -> int:
        """Width of one latent-pool row: ``kv_lora_rank + qk_rope_head_dim``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_hf(cls, d: Mapping[str, Any]) -> "DeepseekConfig":
        if (d.get("moe_layer_freq", 1) or 1) != 1:
            raise NotImplementedError("moe_layer_freq > 1: interleaved dense/MoE layers")
        if d.get("rope_scaling"):
            log.warning(
                "rope_scaling %r is ignored (plain RoPE, as the JAX package computes it): "
                "logits differ from Hugging Face's at long positions", d["rope_scaling"])
        eos = d.get("eos_token_id")
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            moe_intermediate_size=d.get("moe_intermediate_size", d["intermediate_size"]),
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            q_lora_rank=d.get("q_lora_rank"),
            kv_lora_rank=d["kv_lora_rank"],
            qk_rope_head_dim=d["qk_rope_head_dim"],
            qk_nope_head_dim=d["qk_nope_head_dim"],
            v_head_dim=d["v_head_dim"],
            n_routed_experts=d.get("n_routed_experts", 0) or 0,
            num_experts_per_tok=d.get("num_experts_per_tok", 0) or 0,
            n_shared_experts=d.get("n_shared_experts", 0) or 0,
            first_k_dense_replace=d.get("first_k_dense_replace", 0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
            routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
            scoring_func=d.get("scoring_func", "sigmoid"),
            norm_topk_prob=d.get("norm_topk_prob", True),
            n_group=d.get("n_group", 1) or 1,
            topk_group=d.get("topk_group", 1) or 1,
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            moe_layer_freq=d.get("moe_layer_freq", 1) or 1,
            eos_token_ids=tuple(eos) if isinstance(eos, list) else
            ((eos,) if isinstance(eos, int) else ()),
        )


def _interleaved_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's RoPE: de-interleave the pairs, then rotate-half. x
    ``[B, T, h, d]``, cos/sin ``[B, T, d/2]`` in x's dtype."""
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2)
    x1, x2 = x[..., 0], x[..., 1]  # the de-interleaved halves
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def route(cfg: DeepseekConfig, logits: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """DeepSeek-MoE routing from f32 router logits → ``(topw, topi)``
    ``[..., k]`` (JAX ``_moe``): softmax (V2) or sigmoid (V3) scores; the
    scores plus the V3 correction ``bias`` choose the experts
    (:func:`select_experts`), the raw scores weight them."""
    scores = torch.sigmoid(logits) if cfg.scoring_func == "sigmoid" else torch.softmax(logits, -1)
    biased = scores if bias is None else scores + bias.to(torch.float32)
    return select_experts(cfg, scores, biased)


def select_experts(cfg: DeepseekConfig, scores: torch.Tensor, biased: torch.Tensor):
    """Group-limited top-k over ``biased`` (the best ``topk_group`` of
    ``n_group`` groups, each group scored by its two best), weights
    gathered from ``scores``, renormalised if ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    e = cfg.n_routed_experts
    if cfg.n_group > 1 and e % cfg.n_group == 0:
        gsz = e // cfg.n_group
        gs = biased.reshape(*biased.shape[:-1], cfg.n_group, gsz)
        group_scores = torch.topk(gs, min(2, gsz), dim=-1).values.sum(-1)
        top_groups = torch.topk(group_scores, cfg.topk_group, dim=-1).indices
        gmask = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(-1, top_groups, True)
        biased = biased.masked_fill(~gmask.repeat_interleave(gsz, dim=-1), float("-inf"))
    topi = torch.topk(biased, cfg.num_experts_per_tok, dim=-1).indices
    topw = scores.gather(-1, topi)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-20)
    return topw * cfg.routed_scaling_factor, topi


def _moe(cfg: DeepseekConfig, lw: dict, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Routed experts (grouped) plus the shared experts (JAX ``_moe``); the
    router runs in f32 as the JAX package's does."""
    b, t, h = x.shape
    logits = x.to(torch.float32) @ lw["router"].to(torch.float32).T
    topw, topi = route(cfg, logits, lw.get("router_bias"))
    out = moe_grouped_mlp(x.reshape(b * t, h), lw["experts"], topw.reshape(b * t, -1),
                          topi.reshape(b * t, -1), F.silu, plain=plain).reshape(b, t, h)
    if "shared" in lw:
        out = out + _dense_mlp(x, lw["shared"], plain)
    return out


def _mla_attention_paged(cfg, lw, x, cos, sin, cache, li, slots, block_tables, gather_slots,
                         positions, kv_lens, block_size, plain):
    """Absorbed MLA over the paged latent pool (JAX ``_mla_attention_paged``):
    scores = ``[q_lat ‖ q_pe] · row``, values = ``row[:rank]``; this step's
    rows are written into ``cache.pool[li]`` (slot < 0 → the trash row),
    quantized with their scales into a 1-byte pool, whose keys are gathered
    as ``code × scale`` in f32."""
    pool = cache.pool
    b, t, _ = x.shape
    nh, rank, eps = cfg.num_heads, cfg.kv_lora_rank, cfg.rms_norm_eps
    if cfg.q_lora_rank:
        q = linear(rms_norm(linear(x, lw["q_a"], plain=plain), lw["q_a_norm"], eps),
                   lw["q_b"], plain=plain)
    else:
        q = linear(x, lw["q"], plain=plain)
    q = q.reshape(b, t, nh, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_lat = torch.einsum("bthn,hnr->bthr", q_nope, lw["w_uk"].to(q_nope.dtype))
    q_comb = torch.cat([q_lat, _interleaved_rope(q_pe, cos, sin)], dim=-1)  # [B, T, nh, D]
    ckv = linear(x, lw["kv_a"], plain=plain)
    compressed = rms_norm(ckv[..., :rank], lw["kv_a_norm"], eps)
    k_pe = _interleaved_rope(ckv[..., None, rank:], cos, sin)[:, :, 0]
    rows = torch.cat([compressed, k_pe], dim=-1)  # [B, T, D]
    scale = cfg.qk_head_dim ** -0.5
    if t == 1 and not cache.quantized:
        rows = rows.to(pool.dtype)
        lat = mla_decode(q_comb[:, 0].to(pool.dtype).contiguous(), pool, rows[:, 0].contiguous(),
                         slots[:, 0].contiguous(), block_tables, kv_lens, li, rank=rank,
                         block_size=block_size, scale=scale, plain=plain)[:, None]
    else:  # the gather path: a prefill chunk, or any step over a 1-byte pool
        plane = pool[li]
        flat = slots.reshape(-1).to(torch.long)
        safe = torch.where(flat < 0, plane.shape[0] - 1, flat)
        if cache.quantized:
            codes, s = quantize_rows(rows.reshape(b * t, -1), pool.dtype)
            plane[safe] = codes
            cache.scale[li, safe] = s.to(cache.scale.dtype)
            keys = (plane[gather_slots].to(torch.float32)
                    * cache.scale[li][gather_slots].to(torch.float32)[..., None])[:, None]
        else:
            plane[safe] = rows.reshape(b * t, -1).to(pool.dtype)
            keys = plane[gather_slots].to(torch.float32)[:, None]  # [B, 1, P, D]
        pos = torch.arange(keys.shape[2], device=x.device)
        allowed = ((pos[None, None, :] <= positions[:, :, None])
                   & (pos[None, None, :] < kv_lens[:, None, None]))  # [B, T, P]
        qf = q_comb.to(torch.float32).reshape(b, 1, t * nh, -1) * scale
        allowed = allowed.repeat_interleave(nh, dim=1)[:, None]  # rows (token, head)
        lat = _softmax_attend(qf, keys, keys[..., :rank], allowed).reshape(b, t, nh, rank)
    out = torch.einsum("bthr,hvr->bthv", lat.to(torch.float32), lw["w_uv"].to(torch.float32))
    out = out.to(x.dtype).reshape(b, t, nh * cfg.v_head_dim)
    return linear(out, lw["o"], plain=plain)


def deepseek_forward_paged(
    weights: dict,
    cfg: DeepseekConfig,
    input_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    cache: "LatentCache",  # the paged latent pool, updated in place
    block_tables: torch.Tensor,  # [B, W] int32
    slot_mapping: torch.Tensor,  # [B, T] (or [B*T]) write slots (< 0 → dropped)
    kv_lens: torch.Tensor,  # [B] lengths AFTER this step's writes
    *,
    block_size: int,
    compute_dtype=torch.bfloat16,
    logits_last_only: bool = True,
    last_indices: Optional[torch.Tensor] = None,
    plain: bool = False,
):
    """Absorbed-MLA decoder step over the paged latent pool (prefill chunk
    or decode), with the batch, slot and table conventions of
    ``models/llama.py::forward_paged``. Returns ``(logits f32, cache)``;
    ``plain=True`` runs the plain version of every kernel."""
    b, t = input_ids.shape
    dev = input_ids.device
    h = embedding_lookup(input_ids, weights["embed"], dtype=compute_dtype)
    inv = rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta, device=dev)
    cos, sin = (c.to(compute_dtype) for c in rope_cos_sin(positions, inv))
    i32 = dict(dtype=torch.int32, device=dev)
    bt = block_tables.to(**i32).clamp_min(0).contiguous()
    slots = slot_mapping.to(**i32).reshape(b, t)
    kv_lens = kv_lens.to(**i32).contiguous()
    gather_slots = (bt.to(torch.long)[:, :, None] * block_size
                    + torch.arange(block_size, device=dev)).reshape(b, -1)
    positions = positions.to(dev)
    eps = cfg.rms_norm_eps
    for li, lw in enumerate(weights["layers"]):
        x = rms_norm(h, lw["attn_norm"], eps)
        h = h + _mla_attention_paged(cfg, lw, x, cos, sin, cache, li, slots, bt, gather_slots,
                                     positions, kv_lens, block_size, plain)
        x = rms_norm(h, lw["ffn_norm"], eps)
        h = h + (_moe(cfg, lw, x, plain) if "experts" in lw else _dense_mlp(x, lw, plain))
    h = rms_norm(h, weights["final_norm"], eps)
    if logits_last_only:
        if last_indices is not None:
            idx = last_indices.to(device=dev, dtype=torch.long)
            h = h[torch.arange(b, device=dev), idx][:, None]
        else:
            h = h[:, -1:]
    head = weights.get("lm_head")
    if head is None:
        head = weights["embed"]
    return linear(h, head, plain=plain).to(torch.float32), cache


def kernel_workspace(weights: dict, cfg: DeepseekConfig, batch: int, rows, widths,
                     block_size: int, sms: int) -> tuple[int, int]:
    """``(f32 workspace values, int32 counters)`` of the kernels' split
    state that a forward takes (``models/llama.py::kernel_workspace``'s
    rule): any quantized matrix at any row count of ``rows``, and the MLA
    decode kernel over ``batch`` sequences at any width of ``widths``."""
    floats, counters = split_need_tree(weights, rows, sms)
    z = mla_blocks(cfg.num_heads, cfg.kv_lora_rank)
    for w in widths:
        counters = max(counters, mla_counters(mla_plan(batch, z, w, block_size, sms), batch, z))
    return floats, counters


def make_paged_cache(cfg: DeepseekConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, kv_quant=None, device: DeviceLike = None
                     ) -> LatentCache:
    """The paged latent pool ``[L, (num_blocks + 1) * block_size, rank +
    rope]`` on ``device`` (``cuda`` unless the caller asks for ``"cpu"``);
    the trailing block takes dropped writes. One pool for all layers (the
    JAX package keeps one per dense/MoE segment). With ``kv_quant``
    (``"int8"`` or ``"fp8"``) the pool holds 1-byte codes and the cache a
    scale plane ``[L, S_total]`` bf16 (the JAX package's is 128 lanes wide,
    lane 0 used)."""
    dev = resolve_device(device)
    s_total = (num_blocks + 1) * block_size
    if not kv_quant:
        return LatentCache(torch.zeros((cfg.num_layers, s_total, cfg.row_dim), dtype=dtype,
                                       device=dev))
    if kv_quant not in CODE_DTYPES:
        raise ValueError(f"kv_quant must be one of {sorted(CODE_DTYPES)}, got {kv_quant!r}")
    return LatentCache(
        torch.zeros((cfg.num_layers, s_total, cfg.row_dim), dtype=CODE_DTYPES[kv_quant],
                    device=dev),
        torch.zeros((cfg.num_layers, s_total), dtype=torch.bfloat16, device=dev))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def deepseek_weights_from_state_dict(
    sd: Mapping[str, Any], cfg: DeepseekConfig, dtype=torch.bfloat16,
    device: DeviceLike = None,
) -> dict:
    """A Hugging Face DeepSeek state dict (numpy or torch leaves) → the
    port's absorbed weights on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``): the JAX function with ``absorbed=True``, the routed
    experts stacked into ``gateup``/``down`` banks."""
    dev = resolve_device(device)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(name, full=False):
        a = sd[name if full else pre + name]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a, np.float32).copy())
        return t.to(device=dev, dtype=dtype)  # one rounding, as through f32

    def mlp(p):
        return {"gate": g(p + "gate_proj.weight"), "up": g(p + "up_proj.weight"),
                "down": g(p + "down_proj.weight")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        lw = {
            "attn_norm": g(p + "input_layernorm.weight"),
            "ffn_norm": g(p + "post_attention_layernorm.weight"),
            "kv_a": g(p + "self_attn.kv_a_proj_with_mqa.weight"),
            "kv_a_norm": g(p + "self_attn.kv_a_layernorm.weight"),
            "o": g(p + "self_attn.o_proj.weight"),
        }
        # kv_b [nh * (nope + v), rank] → the absorbed per-head factors
        kvb = g(p + "self_attn.kv_b_proj.weight").reshape(
            cfg.num_heads, cfg.qk_nope_head_dim + cfg.v_head_dim, -1)
        lw["w_uk"], lw["w_uv"] = (t.contiguous() for t in
                                  kvb.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=1))
        if cfg.q_lora_rank:
            lw["q_a"] = g(p + "self_attn.q_a_proj.weight")
            lw["q_a_norm"] = g(p + "self_attn.q_a_layernorm.weight")
            lw["q_b"] = g(p + "self_attn.q_b_proj.weight")
        else:
            lw["q"] = g(p + "self_attn.q_proj.weight")
        if i >= cfg.first_k_dense_replace:
            lw["router"] = g(p + "mlp.gate.weight")
            if pre + p + "mlp.gate.e_score_correction_bias" in sd:
                lw["router_bias"] = g(p + "mlp.gate.e_score_correction_bias")
            experts = [mlp(p + f"mlp.experts.{e}.") for e in range(cfg.n_routed_experts)]
            lw["experts"] = {
                "gateup": torch.stack([torch.cat([x["gate"], x["up"]]) for x in experts]),
                "down": torch.stack([x["down"] for x in experts]),
            }
            if cfg.n_shared_experts:
                lw["shared"] = mlp(p + "mlp.shared_experts.")
        else:
            lw.update(mlp(p + "mlp."))
        layers.append(lw)
    return {
        "embed": g("embed_tokens.weight"),
        "layers": layers,
        "final_norm": g("norm.weight"),
        "lm_head": g("lm_head.weight", full=True) if "lm_head.weight" in sd else None,
    }


def init_random_weights(cfg: DeepseekConfig, seed: int = 0, dtype=torch.bfloat16,
                        device: DeviceLike = None) -> dict:
    """Random weights of ``cfg``'s geometry drawn on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``) from a seeded ``torch.Generator``:
    each projection N(0, 1/fan_in) so activations keep their scale through
    the layers, norms at one, the embedding N(0, 1). For tests and the
    card's smoke run (the full DeepSeek-V2-Lite geometry is ~29 GiB in
    bf16, drawn in seconds on the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[-1])).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    hd, nh, rank = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
    e, mi = cfg.n_routed_experts, cfg.moe_intermediate_size
    layers = []
    for i in range(cfg.num_layers):
        lw = {"attn_norm": ones(hd), "ffn_norm": ones(hd),
              "kv_a": w(cfg.row_dim, hd), "kv_a_norm": ones(rank),
              "w_uk": w(nh, cfg.qk_nope_head_dim, rank),
              "w_uv": w(nh, cfg.v_head_dim, rank), "o": w(hd, nh * cfg.v_head_dim)}
        if cfg.q_lora_rank:
            lw.update(q_a=w(cfg.q_lora_rank, hd), q_a_norm=ones(cfg.q_lora_rank),
                      q_b=w(nh * cfg.qk_head_dim, cfg.q_lora_rank))
        else:
            lw["q"] = w(nh * cfg.qk_head_dim, hd)
        if i >= cfg.first_k_dense_replace:
            lw["router"] = w(e, hd)
            lw["experts"] = {"gateup": w(e, 2 * mi, hd), "down": w(e, hd, mi)}
            if cfg.n_shared_experts:
                si = mi * cfg.n_shared_experts
                lw["shared"] = {"gate": w(si, hd), "up": w(si, hd), "down": w(hd, si)}
        else:
            i_d = cfg.intermediate_size
            lw.update(gate=w(i_d, hd), up=w(i_d, hd), down=w(hd, i_d))
        layers.append(lw)
    embed = torch.randn((cfg.vocab_size, hd), generator=gen, device=dev).to(dtype)
    return {"embed": embed, "layers": layers, "final_norm": ones(hd),
            "lm_head": None if cfg.tie_word_embeddings else w(cfg.vocab_size, hd)}
