"""Dense llama-family decoder over the paged KV cache (counterpart of
``mistralrs_tpu/models/llama.py``: ``forward_paged`` at :903, dense branch,
plus ``fuse_projections`` and ``init_random_weights``).

Weights are a plain dictionary. Per-layer weights are a LIST of dictionaries
(one per layer) and the decoder is a Python loop over it, where the JAX
package stacks them and runs ``lax.scan``. A projection is a dense
``[out, in]`` tensor or a planar :class:`QTensor`:

    {"embed": [V, H], "final_norm": [H], "lm_head": [V, H] | None (tied),
     "layers": [{"attn_norm", "ffn_norm", "wq", "wk", "wv" | "wqkv", "wo",
                 "gate", "up" | "wgateup", "down"}, ...]}

Attention runs through the fused paged kernels (``ops/paged_attention.py``):
the decode kernel for one token per row, the prefill kernel otherwise; both
write the step's K/V into the pools in place. MoE, LoRA, M-RoPE, logit
softcaps, sinks and sliding windows are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kv.paged import PagedKVCache
from ..ops.norms import rms_norm
from ..ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from ..ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from ..quant.linear import embedding_lookup, linear
from ..quant.qtensor import QTensor
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for config features the port lacks."""
    unsupported = {
        "mixture-of-experts": cfg.num_experts > 0,
        "M-RoPE": bool(cfg.mrope_section),
        "attention logit softcap": bool(cfg.attn_logit_softcap),
        "final logit softcap": bool(cfg.logit_softcap),
        "sliding window": bool(cfg.sliding_window),
        "q/k norm": cfg.qk_norm,
        "gemma family": cfg.arch.startswith("gemma"),
        f"norm type {cfg.norm_type!r}": cfg.norm_type != "rmsnorm",
        f"activation {cfg.hidden_act!r}": cfg.hidden_act != "silu",
        "parallel residual": cfg.parallel_residual,
        "partial rotary": cfg.partial_rotary_factor != 1.0,
        "interleaved rope": cfg.rope_interleaved,
        "local rope base": cfg.rope_local_theta is not None,
        "NoPE layers": bool(cfg.no_rope_layers),
        "residual/logit/embedding multipliers": bool(
            cfg.residual_multiplier or cfg.logits_scaling or cfg.embedding_multiplier
        ),
        "attention/MLP biases": cfg.attention_bias or cfg.mlp_bias,
    }
    missing = [name for name, on in unsupported.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


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
    h = embedding_lookup(input_ids, weights["embed"], dtype=compute_dtype)
    inv = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                           device=input_ids.device)
    cos, sin = rope_cos_sin(positions, inv)
    attn_scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5
    i32 = dict(dtype=torch.int32, device=input_ids.device)
    block_tables = block_tables.to(**i32).contiguous()
    kv_lens = kv_lens.to(**i32).contiguous()
    slots = slot_mapping.to(**i32).reshape(b, t).contiguous()
    n_valid = (
        (last_indices.to(**i32) + 1) if last_indices is not None
        else torch.full((b,), t, **i32)
    )
    eps = cfg.rms_norm_eps
    for li, lw in enumerate(weights["layers"]):
        x = rms_norm(h, lw["attn_norm"], eps)
        if "wqkv" in lw:
            qkv = linear(x, lw["wqkv"], plain=plain)
            q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        else:
            q = linear(x, lw["wq"], plain=plain)
            k = linear(x, lw["wk"], plain=plain)
            v = linear(x, lw["wv"], plain=plain)
        q = apply_rope(q.reshape(b, t, cfg.num_heads, cfg.head_dim), cos, sin)
        k = apply_rope(k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim), cos, sin)
        v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        k = k.to(cache.k.dtype)
        v = v.to(cache.v.dtype)
        if t == 1:
            attn = paged_decode_attention_fused(
                q[:, 0].contiguous(), cache.k, cache.v, k[:, 0].contiguous(),
                v[:, 0].contiguous(), slots[:, 0].contiguous(), block_tables,
                kv_lens, li, block_size=block_size, scale=attn_scale, plain=plain,
            )[:, None]
        else:
            attn = paged_prefill_attention_fused(
                q.contiguous(), cache.k, cache.v, k.contiguous(), v.contiguous(),
                slots, block_tables, kv_lens, n_valid, li,
                block_size=block_size, scale=attn_scale, plain=plain,
            )
        h = h + linear(attn.reshape(b, t, cfg.q_dim).to(h.dtype), lw["wo"], plain=plain)
        x = rms_norm(h, lw["ffn_norm"], eps)
        if "wgateup" in lw:
            gu = linear(x, lw["wgateup"], plain=plain)
            half = gu.shape[-1] // 2
            hidden = F.silu(gu[..., :half]) * gu[..., half:]
        else:
            hidden = F.silu(linear(x, lw["gate"], plain=plain)) * linear(x, lw["up"], plain=plain)
        h = h + linear(hidden, lw["down"], plain=plain)
    h = rms_norm(h, weights["final_norm"], eps)
    if logits_last_only:
        if last_indices is not None:
            idx = last_indices.to(device=h.device, dtype=torch.long)
            h = h[torch.arange(b, device=h.device), idx][:, None]
        else:
            h = h[:, -1:]
    lm_head = weights.get("lm_head")
    if lm_head is None:
        lm_head = weights["embed"]
    logits = linear(h, lm_head, plain=plain).to(torch.float32)
    return logits, cache


# ---------------------------------------------------------------------------
# weight construction helpers
# ---------------------------------------------------------------------------


def _concat_n(ws):
    """Concat weights along out-features (dense [N, K] or K-major QTensor);
    None when their kinds differ."""
    if all(isinstance(w, QTensor) for w in ws):
        first = ws[0]
        if not all(
            w.packed == first.packed and w.group_size == first.group_size
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
    return torch.cat(ws, dim=0)


def fuse_projections(weights: dict, cfg: ModelConfig) -> dict:
    """Merge each layer's q/k/v into ``wqkv`` and gate/up into ``wgateup``
    (fewer kernel launches per layer); layers whose parts differ in kind
    stay unfused."""
    layers = []
    for lw in weights["layers"]:
        lw = dict(lw)
        for parts, fused_key in ((("wq", "wk", "wv"), "wqkv"), (("gate", "up"), "wgateup")):
            if all(p in lw for p in parts):
                fused = _concat_n([lw[p] for p in parts])
                if fused is not None:
                    lw[fused_key] = fused
                    for p in parts:
                        del lw[p]
        layers.append(lw)
    return {**weights, "layers": layers}


def init_random_weights(
    cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, scale: float = 0.02,
    device: torch.device | str = "cpu",
) -> dict:
    """Random dense weights (testing), drawn from numpy in the same order as
    ``mistralrs_tpu.models.llama.init_random_weights``."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)

    def arr(*shape):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    embed = arr(cfg.vocab_size, H)
    stacked = {
        "wq": arr(L, cfg.q_dim, H), "wk": arr(L, cfg.kv_dim, H),
        "wv": arr(L, cfg.kv_dim, H), "wo": arr(L, H, cfg.q_dim),
        "gate": arr(L, I, H), "up": arr(L, I, H), "down": arr(L, H, I),
    }
    ones = torch.ones(H, dtype=dtype, device=device)
    layers = [
        {"attn_norm": ones.clone(), "ffn_norm": ones.clone(),
         **{k: v[i].contiguous() for k, v in stacked.items()}}
        for i in range(L)
    ]
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones.clone(),
        "lm_head": None if cfg.tie_word_embeddings else arr(cfg.vocab_size, H),
    }
