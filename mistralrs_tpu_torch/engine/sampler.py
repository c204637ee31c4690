"""Batched sampler (counterpart of ``mistralrs_tpu/engine/sampler.py``).

Temperature, top-k, top-p and min-p share one descending sort, as in the JAX
sampler; repetition, frequency and presence penalties and logit bias are
vector ops over a per-slot token-count matrix kept on the device. Greedy
rows (temperature ≤ 0) take the arg-max. Sampled rows draw from a
``torch.Generator`` of their own, seeded per request, so a request's draws
do not depend on what else is in the batch. ``jax.random`` and
``torch.Generator`` give different numbers from one seed: the two packages
agree on greedy tokens and on distributions, not on sampled tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional, Sequence

import torch

NEG_INF = -1e30
TOP_LOGPROBS = 8  # top-k logprobs returned per step (OpenAI top_logprobs)


@dataclass
class SamplingParams:
    """Per-request sampling configuration (host-side; the JAX package's
    fields, so requests carry over unchanged)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0
    min_p: float = 0.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    logit_bias: dict[int, float] = field(default_factory=dict)
    constraint: object = None  # grammar constraints: not ported yet
    max_tokens: int = 512
    stop_token_ids: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    n_logprobs: int = 0
    dry_multiplier: float = 0.0  # DRY penalty: not ported yet
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_sequence_breaker_ids: tuple[int, ...] = ()

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class BatchSamplingState:
    """Device-side per-batch-slot sampling state."""

    temperature: torch.Tensor  # [B] f32 (0 → greedy)
    top_k: torch.Tensor  # [B] i64 (0 → off)
    top_p: torch.Tensor  # [B] f32
    min_p: torch.Tensor  # [B] f32
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor  # [B] f32
    repetition_penalty: torch.Tensor  # [B] f32
    counts: torch.Tensor  # [B, V] i32 token counts (context + generated)
    logit_bias: torch.Tensor  # [B, V] f32

    _SCALARS = ("temperature", "top_k", "top_p", "min_p", "frequency_penalty",
                "presence_penalty", "repetition_penalty")

    @classmethod
    def create(cls, batch: int, vocab_size: int, device) -> "BatchSamplingState":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            temperature=torch.zeros(batch, **f32),
            top_k=torch.zeros(batch, dtype=torch.long, device=device),
            top_p=torch.ones(batch, **f32),
            min_p=torch.zeros(batch, **f32),
            frequency_penalty=torch.zeros(batch, **f32),
            presence_penalty=torch.zeros(batch, **f32),
            repetition_penalty=torch.ones(batch, **f32),
            counts=torch.zeros((batch, vocab_size), dtype=torch.int32, device=device),
            logit_bias=torch.zeros((batch, vocab_size), **f32),
        )

    def admit(self, slot: int, p: SamplingParams, context_ids: Sequence[int]) -> None:
        """Install a request's parameters, context counts and logit bias at
        ``slot`` (ids outside the vocabulary take no part in penalties)."""
        for name in self._SCALARS:
            getattr(self, name)[slot] = getattr(p, name)
        v = self.counts.shape[1]
        ids = torch.as_tensor([i for i in context_ids if 0 <= i < v], dtype=torch.long)
        row = torch.bincount(ids, minlength=v).to(torch.int32)
        self.counts[slot] = row.to(self.counts.device)
        bias = torch.zeros(v, dtype=torch.float32)
        for tok, val in p.logit_bias.items():
            if 0 <= tok < v:
                bias[tok] = val
        self.logit_bias[slot] = bias.to(self.logit_bias.device)


def sample(
    logits: torch.Tensor,  # [R, V] f32, one row per entry of `rows`
    state: BatchSamplingState,
    rows: Sequence[int],  # batch slots of the rows
    generators: Sequence[Optional[torch.Generator]],
):
    """One sampling step over the slots ``rows``. Returns (tokens [R] i64,
    logprobs [R], (top_logprob_vals [R, k], top_ids [R, k])) and adds each
    token to its slot's counts."""
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=logits.device)
    st = {f.name: getattr(state, f.name)[idx] for f in fields(state)}
    v = logits.shape[-1]
    logits = logits.to(torch.float32) + st["logit_bias"]
    counts = st["counts"]
    seen = counts > 0
    rp = st["repetition_penalty"][:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    logits = logits - counts.to(torch.float32) * st["frequency_penalty"][:, None]
    logits = logits - seen.to(torch.float32) * st["presence_penalty"][:, None]

    greedy = st["temperature"] <= 0.0
    temp = torch.where(greedy, torch.ones_like(st["temperature"]), st["temperature"])
    scaled = logits / temp[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    # top_k >= V keeps every token: top-k is off, as at top_k = 0
    k = torch.where(st["top_k"] > 0, st["top_k"].clamp_max(v), torch.full_like(st["top_k"], v))
    kth_val = sorted_logits.gather(1, (k - 1)[:, None])
    include = (cum - probs_sorted) < st["top_p"][:, None]
    last = torch.clamp(include.sum(dim=-1) - 1, 0, v - 1)
    topp_val = sorted_logits.gather(1, last[:, None])
    minp_val = sorted_logits[:, :1] + torch.log(torch.clamp_min(st["min_p"], 1e-20))[:, None]
    minp_val = torch.where(st["min_p"][:, None] > 0, minp_val,
                           torch.full_like(minp_val, float("-inf")))
    threshold = torch.maximum(torch.maximum(kth_val, topp_val), minp_val)
    filtered = torch.where(scaled >= threshold, scaled, torch.full_like(scaled, NEG_INF))

    tokens = torch.argmax(logits, dim=-1)
    for i, (gen, is_greedy) in enumerate(zip(generators, greedy.tolist())):
        if gen is not None and not is_greedy:
            probs = torch.softmax(filtered[i], dim=-1)
            tokens[i] = torch.multinomial(probs, 1, generator=gen)[0]
    logprobs_all = torch.log_softmax(logits, dim=-1)
    logprobs = logprobs_all.gather(1, tokens[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logprobs_all, min(TOP_LOGPROBS, v), dim=-1)
    state.counts[idx, tokens] += 1
    return tokens, logprobs, (top_vals, top_ids)
