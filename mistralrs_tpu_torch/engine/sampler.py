"""Batched sampler (counterpart of ``mistralrs_tpu/engine/sampler.py``).

Temperature, top-k, top-p and min-p share one descending sort, as in the JAX
sampler; repetition, frequency and presence penalties, logit bias and the
per-slot constraint bias (grammar masks at −1e30 plus the DRY penalty,
written by the engine from the host between steps) are vector ops over
per-slot rows kept on the device. Greedy rows (temperature ≤ 0) take the
arg-max. :func:`dry_penalty_row` runs on the host, as in the JAX package.

Sampled rows draw on the device with no host round trip, as
``jax.random.categorical`` does: the arg-max of the filtered logits plus
Gumbel noise. The noise of token ``t`` in a row is a counter-based hash of
(the request's seed, the number of tokens it has drawn, ``t``), from
per-slot state that :meth:`BatchSamplingState.admit` writes, so a request's
draws do not depend on its slot or on what else is in the batch, and the
same function serves one row (the first token, from prefill logits) or the
whole slot batch (the decode step, captured in a CUDA graph). The hash is
integer tensor arithmetic that gives the same bits on the CPU and on CUDA
(32-bit values held in int64: every product stays below 2**63, and every
shifted value is non-negative, so the arithmetic shift is the logical one).
``jax.random`` draws other numbers from one seed: the two packages agree on
greedy tokens and on distributions, not on sampled tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30
TOP_LOGPROBS = 8  # top-k logprobs returned per step (OpenAI top_logprobs)
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (Wellons' ``lowbias32`` constants
    0x21f0aaad / 0x735a2d97) of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def row_keys(seed_lo: torch.Tensor, seed_hi: torch.Tensor, drawn: torch.Tensor) -> torch.Tensor:
    """One 32-bit key per row from its seed's halves and its draw count."""
    k = _mix32(seed_lo ^ 0x9E3779B9)
    k = _mix32(k ^ seed_hi)
    return _mix32(k ^ (drawn & _M32))


def token_hashes(vocab_size: int, device) -> torch.Tensor:
    """The per-token half of the noise hash, ``[V]`` int64."""
    return _mix32(torch.arange(vocab_size, dtype=torch.int64, device=device) ^ 0x85EBCA6B)


def gumbel_noise(keys: torch.Tensor, tok_hash: torch.Tensor) -> torch.Tensor:
    """Gumbel noise ``[R, V]`` f64 from row keys ``[R]`` and token hashes
    ``[V]``: a uniform in (0, 1) from 32 hashed bits, then ``-log(-log u)``."""
    bits = _mix32(keys[:, None] ^ tok_hash[None, :])
    u = (bits.to(torch.float64) + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


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
    # grammar constraint: None | "json_object" | "json" | "regex:..." |
    # "lark:..." | a recognizer object (grammar.py, cfg_grammar.py)
    constraint: object = None
    max_tokens: int = 512
    stop_token_ids: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    n_logprobs: int = 0
    # DRY repetition penalty (reference: `mistralrs-core/src/dry.rs`):
    # penalize tokens that would extend a sequence already seen in the context
    dry_multiplier: float = 0.0  # 0 → disabled
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_sequence_breaker_ids: tuple[int, ...] = ()

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


_DRY_MAX_NGRAM = 50


def dry_penalty_row(
    ctx, params: "SamplingParams", vocab_size: int
) -> Optional[np.ndarray]:
    """Negative logit adjustments [V] for the DRY repetition penalty, or None
    when nothing matches (a copy of JAX ``dry_penalty_row``). ``ctx`` is the
    full token context (prompt + output).

    For every earlier occurrence of the current last token, the token that
    followed it is penalized by ``multiplier * base^(match_len -
    allowed_length)`` where ``match_len`` is the length of the repeated
    suffix (reference semantics: `mistralrs-core/src/dry.rs`)."""
    n = len(ctx)
    if params.dry_multiplier <= 0.0 or n < 2:
        return None
    breakers = set(params.dry_sequence_breaker_ids)
    last = ctx[-1]
    if last in breakers:
        return None
    pen: dict[int, float] = {}
    for i in range(n - 1):
        if ctx[i] != last:
            continue
        length = 1
        while (
            length < _DRY_MAX_NGRAM
            and length <= i
            and n - 1 - length >= 0
            and ctx[i - length] == ctx[n - 1 - length]
            and ctx[i - length] not in breakers
        ):
            length += 1
        cand = ctx[i + 1]
        if cand in breakers or not 0 <= cand < vocab_size:
            continue
        if length >= params.dry_allowed_length:
            v = params.dry_multiplier * (
                params.dry_base ** (length - params.dry_allowed_length)
            )
            if v > pen.get(cand, 0.0):
                pen[cand] = v
    if not pen:
        return None
    row = np.zeros((vocab_size,), np.float32)
    for t, v in pen.items():
        row[t] = -v
    return row


@dataclass
class BatchSamplingState:
    """Device-side per-batch-slot sampling state. Every tensor keeps its
    storage for the engine's life (a captured decode step reads them by
    address): :meth:`admit` and :func:`sample` update them in place."""

    temperature: torch.Tensor  # [B] f32 (0 → greedy)
    top_k: torch.Tensor  # [B] i64 (0 → off)
    top_p: torch.Tensor  # [B] f32
    min_p: torch.Tensor  # [B] f32
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor  # [B] f32
    repetition_penalty: torch.Tensor  # [B] f32
    counts: torch.Tensor  # [B, V] i32 token counts (context + generated)
    logit_bias: torch.Tensor  # [B, V] f32
    constraint_bias: torch.Tensor  # [B, V] f32 (0 or −1e30 grammar masks, plus DRY)
    seed_lo: torch.Tensor  # [B] i64, the request seed's low 32 bits
    seed_hi: torch.Tensor  # [B] i64, its next 32 bits
    drawn: torch.Tensor  # [B] i64 tokens the request has drawn
    tok_hash: torch.Tensor  # [V] i64 (token_hashes; the same for every slot)

    _SCALARS = ("temperature", "top_k", "top_p", "min_p", "frequency_penalty",
                "presence_penalty", "repetition_penalty")
    _ROWS = _SCALARS + ("counts", "logit_bias", "constraint_bias", "seed_lo", "seed_hi",
                        "drawn")

    @classmethod
    def create(cls, batch: int, vocab_size: int, device) -> "BatchSamplingState":
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.long, device=device)
        return cls(
            temperature=torch.zeros(batch, **f32),
            top_k=torch.zeros(batch, **i64),
            top_p=torch.ones(batch, **f32),
            min_p=torch.zeros(batch, **f32),
            frequency_penalty=torch.zeros(batch, **f32),
            presence_penalty=torch.zeros(batch, **f32),
            repetition_penalty=torch.ones(batch, **f32),
            counts=torch.zeros((batch, vocab_size), dtype=torch.int32, device=device),
            logit_bias=torch.zeros((batch, vocab_size), **f32),
            constraint_bias=torch.zeros((batch, vocab_size), **f32),
            seed_lo=torch.zeros(batch, **i64),
            seed_hi=torch.zeros(batch, **i64),
            drawn=torch.zeros(batch, **i64),
            tok_hash=token_hashes(vocab_size, device),
        )

    def admit(self, slot: int, p: SamplingParams, context_ids: Sequence[int], seed: int,
              drawn: int = 0) -> None:
        """Install a request's parameters, context counts, logit bias and
        draw state (``seed``; ``drawn`` tokens drawn so far, which a
        recomputed request keeps) at ``slot`` (ids outside the vocabulary
        take no part in penalties), and clear its constraint bias (the
        engine writes a constrained or DRY request's row after this)."""
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
        self.constraint_bias[slot].zero_()
        self.seed_lo[slot] = seed & _M32
        self.seed_hi[slot] = (seed >> 32) & _M32
        self.drawn[slot] = drawn


def sample(
    logits: torch.Tensor,  # [R, V] f32, one row per slot of `rows`
    state: BatchSamplingState,
    rows: Optional[torch.Tensor] = None,  # [R] int64 slots; None → every slot, in order
    update: Optional[torch.Tensor] = None,  # [R] bool: rows that take their token
):
    """One sampling step over the slots ``rows``, on the device with no host
    sync. Returns (tokens [R] i64, logprobs [R], (top_logprob_vals [R, k],
    top_ids [R, k])). Each row of ``update`` (every row when None) adds its
    token to its slot's counts and one to its draw count; the others leave
    their slot's state as it was (the decode step's empty slots)."""
    r, v = logits.shape
    idx = (torch.arange(r, device=logits.device) if rows is None
           else rows.to(device=logits.device, dtype=torch.long))
    st = {name: getattr(state, name)[idx] for name in BatchSamplingState._ROWS}
    logits = logits.to(torch.float32) + st["logit_bias"] + st["constraint_bias"]
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

    noise = gumbel_noise(row_keys(st["seed_lo"], st["seed_hi"], st["drawn"]), state.tok_hash)
    sampled = torch.argmax(filtered.to(torch.float64) + noise, dim=-1)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    logprobs_all = torch.log_softmax(logits, dim=-1)
    logprobs = logprobs_all.gather(1, tokens[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logprobs_all, min(TOP_LOGPROBS, v), dim=-1)
    upd = (torch.ones(r, dtype=torch.long, device=logits.device) if update is None
           else update.to(torch.long))
    state.counts.view(-1).scatter_add_(0, idx * v + tokens, upd.to(torch.int32))
    state.drawn.scatter_add_(0, idx, upd)
    return tokens, logprobs, (top_vals, top_ids)
