"""The serving engine: continuous batching over the paged KV cache
(counterpart of ``mistralrs_tpu/engine/engine.py``).

* Decode runs a **fixed slot batch** of ``max_batch`` rows
  (``engine/engine.py:73-87`` and ``_run_decode`` in the JAX package); empty
  slots carry dummy tokens whose KV writes are dropped (slot −1). The step
  (``engine/decode_step.py``, the counterpart of the jitted ``_decode_fn``)
  is the forward plus on-device seeded sampling over every slot: on the
  card one captured CUDA graph per block-table width bucket, replayed every
  step, whose only host wait is one copy of the step's results; on the CPU
  the same function uncaptured. The KV pools and the sampling state are the
  same tensors for the engine's life, updated in place.
* Prompt chunks of up to ``prefill_chunk`` tokens from up to four sequences
  run as one batched prefill (``_run_prefill_batch``), eagerly (not
  captured); a sequence finishing its prompt samples its first token from
  the prefill logits through the same sampler.
* Prefix caching and recompute preemption come from the block manager and
  scheduler, copied from the JAX package.

* An arch adapter (``adapter=``, ``engine/adapters.py``) brings its own
  cache and forward: the engine then runs the adapter's ``prefill`` and
  ``decode`` in place of the llama decoder (DeepSeek's absorbed MLA).
* ``kv_quant`` (``"int8"`` or ``"fp8"``) serves from 1-byte KV pools with
  per-(layer, head, slot) scales (``kv/paged.py``), or an adapter's own
  quantized cache where the adapter has one (``supports_kv_quant``). The
  1-byte kernel forms take every option of the bf16 ones (sliding windows,
  logit softcaps, attention sinks, head_dim 64, 80, 96, 128 and 256).
* A llama-family model whose GQA group (query heads per KV head) is over 16
  is refused before the pools are reserved: the decode kernel takes groups
  1 to 16.
* Grammar constraints (``SamplingParams.constraint``: JSON, regex, Lark,
  a choice or a recognizer object; ``grammar.py``, ``cfg_grammar.py``) and
  the DRY penalty run on the host between steps, as in the JAX engine: each
  committed token advances the request's recognizer, and the next mask
  (−1e30 where the recognizer would die; EOS only once it is complete) plus
  the DRY row is written into the slot's ``constraint_bias`` row, which the
  captured step reads in place (``DecodeStep.set_bias_row``). A request
  whose output completes its constraint stops (``STOP_TOKEN``). A
  constraint the engine cannot resolve, or one given to an engine without a
  tokenizer, is refused when the request is added.
* Every step (and :meth:`Engine.embed`) holds the device's lock
  (``ops/_cuda.py::device_lock``), so engines that share a card take turns
  on its split state.

Speculative decoding, tensor/data parallelism and LoRA adapters are not
ported yet.
"""

from __future__ import annotations

import functools
import itertools
import time
import traceback
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kv.manager import KVCacheManager
from ..kv.paged import PagedKVCache
from ..models.config import ModelConfig
from ..models.llama import check_supported, forward_paged, kernel_workspace
from ..ops._cuda import device_lock, sm_count
from ..ops.paged_attention import DECODE_MAX_GROUP
from ..quant.fp8 import Fp8Tensor
from ..quant.qtensor import QTensor
from .decode_step import KV_LEN, POSITION, SLOT, TABLE, TOKEN, DecodeStep
from .sampler import BatchSamplingState, SamplingParams, dry_penalty_row, sample
from .scheduler import Scheduler
from .sequence import Sequence, StopReason


def _bucket(n: int) -> int:
    """Prefill rows are padded to a power of two of at least 16 tokens (the
    JAX package's buckets up to 1024, and on by powers of two past it, so a
    chunk of any length fits its row)."""
    b = 16
    while b < n:
        b *= 2
    return b


def decode_widths(max_model_len: int, block_size: int) -> list[int]:
    """Every block-table width ``Engine._max_blocks_bucket`` can return."""
    hard_max = -(-max_model_len // block_size)
    if hard_max < 32:
        return [hard_max]
    widths = [32]
    while widths[-1] < hard_max:
        widths.append(min(2 * widths[-1], hard_max))
    return widths


def forward_rows(max_batch: int, prefill_chunk: int, max_prefill_seqs: int) -> list[int]:
    """Every token-row count an engine's forward takes: the decode batch,
    and each prefill's (rows padded to a power of two, times a token
    bucket; its logits rows alone)."""
    rows, r = {max_batch}, 1
    while True:
        t = 16
        while True:
            rows.update((r, r * t))
            if t >= _bucket(prefill_chunk):
                break
            t *= 2
        if r >= max_prefill_seqs:
            return sorted(rows)
        r *= 2


def weights_to(weights, device: torch.device):
    """Move a weight tree (dicts, lists, tensors, QTensors, Fp8Tensors) to ``device``;
    leaves already there are not copied."""
    if isinstance(weights, dict):
        return {k: weights_to(v, device) for k, v in weights.items()}
    if isinstance(weights, list):
        return [weights_to(v, device) for v in weights]
    if isinstance(weights, (torch.Tensor, QTensor, Fp8Tensor)):
        return weights.to(device)
    return weights


@functools.lru_cache(maxsize=64)
def _recognizer(c: str):
    """The recognizer of a constraint string (``Engine._resolve_constraint``)."""
    from ..grammar import JsonConstraint, RegexConstraint

    if c in ("json_object", "json"):
        return JsonConstraint(root="object" if c == "json_object" else "any")
    if c.startswith("regex:"):
        return RegexConstraint(c[len("regex:"):])
    if c.startswith("lark:"):
        from ..cfg_grammar import LarkConstraint

        return LarkConstraint(c[len("lark:"):])
    raise ValueError(f"unknown constraint {c!r}")

class Engine:
    """Single-model serving engine (synchronous step loop; the server drives
    it from its engine thread)."""

    def __init__(
        self,
        cfg: ModelConfig,
        weights: dict,
        *,
        num_blocks: int = 512,
        block_size: int = 16,
        max_batch: int = 8,
        max_model_len: Optional[int] = None,
        prefill_chunk: int = 512,
        compute_dtype=torch.bfloat16,
        kv_quant: Optional[str] = None,
        enable_prefix_caching: bool = True,
        tokenizer=None,
        seed: int = 0,
        device: DeviceLike = None,
        adapter=None,
    ):
        """With ``adapter`` (``engine/adapters.py``), ``cfg`` is the
        adapter's config and the adapter's weights serve; ``weights`` is
        not used."""
        self.device = resolve_device(device)
        self.adapter = adapter
        if adapter is None:
            check_supported(cfg)
            group = cfg.num_heads // cfg.num_kv_heads
            if cfg.num_heads % cfg.num_kv_heads or not 1 <= group <= DECODE_MAX_GROUP:
                # before the pools: the decode kernel takes groups 1..16 (the
                # prefill kernel 1..64)
                raise NotImplementedError(
                    f"GQA group {cfg.num_heads}/{cfg.num_kv_heads}: the paged decode kernel "
                    f"takes groups 1..{DECODE_MAX_GROUP}")
            self.weights = weights_to(weights, self.device)
        else:
            if adapter.device != self.device:
                raise ValueError(f"adapter on {adapter.device}, engine on {self.device}")
            if kv_quant is not None and not getattr(adapter, "supports_kv_quant", False):
                raise NotImplementedError(
                    f"{type(adapter).__name__} does not support quantized KV")
            if not adapter.supports_prefix_cache:
                enable_prefix_caching = False
            self.weights = None
        self.cfg = cfg
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_model_len = max_model_len or cfg.max_position_embeddings
        self.compute_dtype = compute_dtype
        self.kv_quant = kv_quant
        self.tokenizer = tokenizer
        self.seed = seed
        self.kv = KVCacheManager(num_blocks, block_size, enable_prefix_caching)
        self.scheduler = Scheduler(self.kv, max_batch, prefill_chunk)
        if adapter is None:
            self.cache = PagedKVCache.create(cfg, num_blocks, block_size, dtype=compute_dtype,
                                             kv_quant=kv_quant, device=self.device)
        else:
            self.cache = adapter.create_cache(num_blocks, block_size, max_batch,
                                              kv_quant=kv_quant)
        self.samp_state = BatchSamplingState.create(max_batch, cfg.vocab_size, self.device)
        workspace = (0, 0)
        if self.device.type == "cuda":
            args = (max_batch, forward_rows(max_batch, prefill_chunk,
                                            self.scheduler.max_prefill_seqs),
                    decode_widths(self.max_model_len, block_size))
            sms = sm_count(self.device)
            workspace = (kernel_workspace(self.weights, cfg, *args, block_size, sms)
                         if adapter is None else adapter.kernel_workspace(*args, sms))
        self.decode_step = DecodeStep(self._decode_forward, self.samp_state, max_batch,
                                      self.device, workspace)
        self._req_counter = itertools.count()
        self._slot_seq: list[Optional[Sequence]] = [None] * max_batch
        self._mask_builder = None  # grammar.TokenMaskBuilder, built at the first constraint
        self.stats = {
            "prompt_tokens": 0, "generated_tokens": 0, "preemptions": 0,
            "prefix_cache_hit_tokens": 0, "steps": 0,
        }

    def add_request(
        self,
        prompt_ids: list[int],
        params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        on_tokens=None,
        priority: int = 0,
    ) -> Sequence:
        params = params or SamplingParams()
        if len(prompt_ids) >= self.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt_ids)} ≥ max_model_len {self.max_model_len}"
            )
        cons = self._resolve_constraint(params.constraint)
        if cons is not None:
            self._get_mask_builder()  # no tokenizer → ValueError, before the request waits
        n = next(self._req_counter)
        seq = Sequence(
            request_id=request_id or f"req-{n}",
            prompt_ids=list(prompt_ids),
            params=params,
            on_tokens=on_tokens,
            priority=priority,
        )
        seq.sample_seed = (params.seed if params.seed is not None
                           else (self.seed * 1_000_003 + n) % (2**63))
        if cons is not None:
            seq.constraint, seq.constraint_state = cons, cons.initial()
        self.scheduler.add(seq)
        return seq

    def abort(self, request_id: str) -> Optional[Sequence]:
        seq = self.scheduler.abort(request_id)
        if seq is not None and seq.slot is not None:
            self._slot_seq[seq.slot] = None
        return seq

    # -- stepping ------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self) -> list[Sequence]:
        """Run one engine step, under the device's lock. Returns sequences
        that finished this step. A forward error finishes the sequences of
        that forward with ERROR and leaves the engine running."""
        with device_lock(self.device):
            return self._step()

    def _step(self) -> list[Sequence]:
        out = self.scheduler.schedule()
        self.stats["steps"] += 1
        self.stats["preemptions"] = self.scheduler.num_preemptions
        live = {id(s) for s in self.scheduler.running}
        for i, s in enumerate(self._slot_seq):
            if s is not None and id(s) not in live:
                self._slot_seq[i] = None
        if out.is_empty:
            return []
        finished: list[Sequence] = []
        if out.decode:
            t0 = time.monotonic()
            try:
                finished.extend(self._run_decode(out.decode))
            except Exception as e:  # noqa: BLE001 — contain per request
                self._fail_sequences(out.decode, e)
                finished.extend(out.decode)
            self.stats["decode_steps"] = self.stats.get("decode_steps", 0) + 1
            self.stats["decode_time_s"] = (
                self.stats.get("decode_time_s", 0.0) + time.monotonic() - t0
            )
        if out.prefills:
            t0 = time.monotonic()
            try:
                finished.extend(self._run_prefill_batch(out.prefills))
            except Exception as e:  # noqa: BLE001 — contain per request
                seqs = [sp.seq for sp in out.prefills]
                self._fail_sequences(seqs, e)
                finished.extend(seqs)
            self.stats["prefill_steps"] = self.stats.get("prefill_steps", 0) + 1
            self.stats["prefill_time_s"] = (
                self.stats.get("prefill_time_s", 0.0) + time.monotonic() - t0
            )
        return finished

    def _fail_sequences(self, seqs: list[Sequence], err: Exception) -> None:
        traceback.print_exc()
        self.stats["forward_errors"] = self.stats.get("forward_errors", 0) + 1
        for seq in seqs:
            seq.error = f"{type(err).__name__}: {err}"  # type: ignore[attr-defined]
            seq.finish(StopReason.ERROR)
            if seq.slot is not None:
                self._slot_seq[seq.slot] = None
            self.scheduler.release(seq)
            if seq.on_tokens is not None:
                seq.on_tokens([], True)

    def run_to_completion(self) -> list[Sequence]:
        """Drain all queued work (batch/offline mode)."""
        finished = []
        while self.has_work:
            finished.extend(self.step())
        return finished

    def embed(self, token_batches, *, pooling: str = "last",
              normalize: bool = True) -> np.ndarray:
        """Sequence embeddings (``embeddings.embed``) of this engine's model
        on its device, under the device's lock (between steps) → ``[B, H]``
        f32. The batch runs as forwards of ``r`` sequences padded to ``t``
        tokens, ``r`` a power of two up to the scheduler's
        ``max_prefill_seqs`` and ``t`` a prefill bucket, which are token-row
        counts the engine reserved the kernels' split state for; trailing
        padding changes no pooled row (causal attention; ``mean`` pools the
        valid tokens). An input longer than the largest bucket raises
        ``ValueError``."""
        from ..embeddings import embed

        if self.adapter is not None:
            raise NotImplementedError(
                f"embeddings of {type(self.adapter).__name__} models are not ported")
        batches = [list(b) for b in token_batches]
        longest = _bucket(self.scheduler.prefill_chunk)
        if any(len(b) > longest for b in batches):
            raise ValueError(f"an input of {max(len(b) for b in batches)} tokens is longer "
                             f"than the engine's prefill bucket of {longest}")
        per = self.scheduler.max_prefill_seqs
        out = []
        with device_lock(self.device):
            for lo in range(0, len(batches), per):
                group = batches[lo:lo + per]
                r = 1
                while r < len(group):
                    r *= 2
                t = _bucket(max(1, max(len(b) for b in group)))
                vecs = embed(self.weights, self.cfg, group + [[0]] * (r - len(group)),
                             pooling=pooling, normalize=normalize, max_len=t,
                             device=self.device)
                out.append(vecs[:len(group)])
        if not out:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        return np.concatenate(out)

    def close(self) -> None:
        """Release the device memory the engine holds: the decode step's
        graphs and their pool, the KV pools, the sampling state and the
        weights (the engine cannot step afterwards)."""
        with device_lock(self.device):
            self.decode_step.close()
            self.decode_step.forward = None
            self.cache = self.weights = self.adapter = None
            self.samp_state = self.decode_step.state = None
            self._slot_seq = [None] * self.max_batch

    # -- internals -----------------------------------------------------------

    def _max_blocks_bucket(self) -> int:
        hard_max = -(-self.max_model_len // self.block_size)
        longest = 1
        for s in self.scheduler.running:
            longest = max(longest, len(self.kv.block_table(s.request_id)))
        b = 32
        while b < longest:
            b *= 2
        return min(b, hard_max) if hard_max >= 32 else hard_max

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_prefill_batch(self, sps) -> list[Sequence]:
        """Run this step's prompt chunks as ONE batched forward (rows padded
        to a power of two, tokens to a bucket; pad tokens write nothing)."""
        r = 1
        while r < len(sps):
            r *= 2
        t = _bucket(max(sp.length for sp in sps))
        ids_arr = np.zeros((r, t), np.int64)
        positions = np.zeros((r, t), np.int64)
        slot_map = np.full((r, t), -1, np.int32)
        kv_lens = np.ones((r,), np.int32)
        last_idx = np.zeros((r,), np.int64)
        width = self._max_blocks_bucket()
        for sp in sps:
            need = len(self.kv.block_table(sp.seq.request_id))
            while width < need:
                width *= 2
        bt = np.zeros((r, width), np.int32)
        for row, sp in enumerate(sps):
            seq = sp.seq
            ids_arr[row, : sp.length] = seq.prompt_ids[sp.start : sp.start + sp.length]
            positions[row, : sp.length] = np.arange(sp.start, sp.start + sp.length)
            slot_map[row, : sp.length] = self.kv.slot_mapping(seq.request_id, sp.start, sp.length)
            table = self.kv.block_table(seq.request_id)[:width]
            bt[row, : len(table)] = table
            kv_lens[row] = sp.start + sp.length
            last_idx[row] = sp.length - 1
        ids, pos = self._dev(ids_arr), self._dev(positions)
        args = (self._dev(bt), self._dev(slot_map), self._dev(kv_lens))
        if self.adapter is not None:
            logits, cache = self.adapter.prefill(self.cache, ids, pos, *args,
                                                 self._dev(last_idx))
        else:
            logits, cache = forward_paged(
                self.weights, self.cfg, ids, pos, self.cache, *args, block_size=self.block_size,
                logits_last_only=True, compute_dtype=self.compute_dtype,
                last_indices=self._dev(last_idx),
            )
        self._check_cache(cache)
        finished: list[Sequence] = []
        for row, sp in enumerate(sps):
            seq = sp.seq
            self.stats["prompt_tokens"] += sp.length
            self.stats["prefix_cache_hit_tokens"] += sp.cached
            self.kv.publish_full_blocks(seq.request_id, sp.start + sp.length)
            if sp.start + sp.length >= seq.prompt_len:
                if self._admit_and_sample_first(seq, logits[row, 0]):
                    finished.append(seq)
        return finished

    def _admit_and_sample_first(self, seq: Sequence, logits_row) -> bool:
        """Install the finished prompt's slot state and sample its first token
        from the prefill logits. Returns True if the sequence finished."""
        slot = seq.slot
        self._slot_seq[slot] = seq
        self.samp_state.admit(slot, seq.params, seq.prompt_ids, seq.sample_seed,
                              drawn=seq.num_generated)
        # the first mask (from the recognizer's state: initial, or where a
        # recomputed request's output left it) plus DRY over the context
        row = self._bias_row(seq, list(seq.prompt_ids), seq.constraint is not None)
        if row is not None:
            self.decode_step.set_bias_row(slot, row)
        toks, logprobs, tops = sample(logits_row[None], self.samp_state,
                                      rows=torch.tensor([slot], device=self.device))
        seq.first_token_time = time.monotonic()
        return self._commit_token(seq, int(toks[0]), float(logprobs[0]),
                                  tops[0][0].cpu().numpy(), tops[1][0].cpu().numpy())

    def _check_cache(self, cache) -> None:
        if cache is not self.cache:
            raise RuntimeError("the forward must update the KV cache in place and return it: "
                               "a captured decode step holds its tensors")

    def _decode_forward(self, tokens, positions, bt, slot_map, kv_lens) -> torch.Tensor:
        """The decode step's forward (``DecodeStep``): logits ``[B, 1, V]``,
        the KV rows written into the engine's cache in place."""
        if self.adapter is not None:
            logits, cache = self.adapter.decode(self.cache, tokens, positions, bt, slot_map,
                                                kv_lens)
        else:
            logits, cache = forward_paged(
                self.weights, self.cfg, tokens, positions, self.cache, bt, slot_map, kv_lens,
                block_size=self.block_size, logits_last_only=True,
                compute_dtype=self.compute_dtype,
            )
        self._check_cache(cache)
        return logits

    def _run_decode(self, seqs: list[Sequence]) -> list[Sequence]:
        width = self._max_blocks_bucket()
        stage = self.decode_step.staging(width)  # rows without a sequence stay empty
        for seq in seqs:
            s = seq.slot
            # the last generated token's KV is written this step at position
            # total_len - 1 (the first token was sampled from prefill logits)
            pos = seq.total_len - 1
            stage[s, TOKEN] = seq.all_ids[-1]
            stage[s, POSITION] = pos
            stage[s, SLOT] = self.kv.slot_mapping(seq.request_id, pos, 1)[0]
            stage[s, KV_LEN] = pos + 1
            table = self.kv.block_table(seq.request_id)[:width]
            stage[s, TABLE:TABLE + len(table)] = table
        toks, logprobs, top_vals, top_ids = self.decode_step.run(width)
        finished: list[Sequence] = []
        for seq in seqs:
            s = seq.slot
            if self._commit_token(seq, int(toks[s]), float(logprobs[s]), top_vals[s],
                                  top_ids[s]):
                finished.append(seq)
        return finished

    def _commit_token(self, seq: Sequence, tok: int, logprob: float,
                      top_vals_row, top_ids_row) -> bool:
        """Advance the grammar state, record one sampled token, publish
        KV-complete blocks, run the stop checks and, for a sequence that goes
        on, write its next constraint-bias row. Returns True if the sequence
        finished."""
        constrained = seq.constraint is not None
        if constrained:
            st = self._get_mask_builder().advance_with_token(
                seq.constraint, seq.constraint_state, tok)
            if st is not None and seq.constraint.is_complete(st):
                seq.constraint_done = True
            if st is None or seq.constraint_done:  # dead or complete: no more masks
                seq.constraint, seq.constraint_state = None, None
            else:
                seq.constraint_state = st
        if seq.first_token_time is None:
            seq.first_token_time = time.monotonic()
        seq.output_ids.append(tok)
        seq.output_logprobs.append(logprob)
        if seq.params.n_logprobs > 0:
            k = min(seq.params.n_logprobs, top_ids_row.shape[0])
            seq.output_top_logprobs.append(
                {int(i): float(v) for i, v in zip(top_ids_row[:k], top_vals_row[:k])}
            )
        self.stats["generated_tokens"] += 1
        self.kv.extend_hashes(seq.request_id, seq.all_ids)
        # the token just sampled has no KV yet (written next step)
        self.kv.publish_full_blocks(seq.request_id, seq.total_len - 1)
        reason = self._check_stop(seq, tok)
        if seq.on_tokens is not None:
            seq.on_tokens([tok], reason is not None)
        if reason is not None:
            s = seq.slot
            seq.finish(reason)
            self.scheduler.release(seq)
            self._slot_seq[s] = None
            return True
        if constrained or seq.params.dry_multiplier > 0.0:
            # zeros once the constraint is dead or complete (JAX engine.py:1325-1337)
            row = self._bias_row(seq, seq.all_ids, constrained)
            self.decode_step.set_bias_row(seq.slot, row)
        return False

    def _bias_row(self, seq: Sequence, ctx: list[int], constrained: bool):
        """The slot's constraint-bias row: the mask of the sequence's
        recognizer state (0 allowed, −1e30 not), plus the DRY penalty over
        ``ctx``; zeros for a sequence that was constrained until now; None
        for one that is neither constrained nor penalized."""
        row = None
        if seq.constraint is not None:
            t0 = time.monotonic()
            allow = self._get_mask_builder().mask(seq.constraint, seq.constraint_state,
                                                  self.cfg.eos_token_ids)
            row = np.where(allow, 0.0, -1e30).astype(np.float32)
            self.stats["constraint_masks"] = self.stats.get("constraint_masks", 0) + 1
            self.stats["constraint_mask_s"] = (
                self.stats.get("constraint_mask_s", 0.0) + time.monotonic() - t0)
        if seq.params.dry_multiplier > 0.0:
            dry = dry_penalty_row(ctx, seq.params, self.cfg.vocab_size)
            if dry is not None:
                row = dry if row is None else row + dry
        if row is None and constrained:
            row = np.zeros((self.cfg.vocab_size,), np.float32)
        return row

    def _resolve_constraint(self, c):
        """A request's constraint → its recognizer: ``"json_object"``
        (an object at the root), ``"json"`` (any value), ``"regex:<pattern>"``,
        ``"lark:<grammar>"``, or a recognizer object as given. An unknown
        string raises ``ValueError``. Requests that give the same string
        share its recognizer, and so its transition table in the mask
        builder (recognizers hold no state of a request)."""
        if c is None:
            return None
        return _recognizer(c) if isinstance(c, str) else c

    def _get_mask_builder(self):
        if self._mask_builder is None:
            if self.tokenizer is None:
                raise ValueError("grammar constraints require a tokenizer")
            from ..grammar import TokenMaskBuilder

            self._mask_builder = TokenMaskBuilder(self.tokenizer, self.cfg.vocab_size)
        return self._mask_builder

    def _check_stop(self, seq: Sequence, tok: int) -> Optional[StopReason]:
        p = seq.params
        if seq.constraint_done:
            return StopReason.STOP_TOKEN
        if tok in p.stop_token_ids:
            return StopReason.STOP_TOKEN
        if tok in self.cfg.eos_token_ids:
            return StopReason.EOS
        if seq.num_generated >= p.max_tokens:
            return StopReason.LENGTH
        if seq.total_len >= self.max_model_len:
            return StopReason.LENGTH
        if p.stop_strings and self.tokenizer is not None:
            max_ss = max(len(ss) for ss in p.stop_strings)
            ntok = min(len(seq.output_ids), max_ss + 8)
            text = self.tokenizer.decode(seq.output_ids[-ntok:])
            if any(ss in text for ss in p.stop_strings):
                return StopReason.STOP_STRING
        return None
