"""Continuous-batching scheduler over the paged KV pool (a copy of
``mistralrs_tpu/engine/scheduler.py``).

The analog of the reference's `PagedAttentionScheduler`
(`mistralrs-core/src/paged_attention/scheduler.rs:64`): waiting/running
queues, block allocation on admission with prefix-cache lookup, chunked
prefill, and FCFS+priority preemption when the pool runs dry (`_preempt`,
scheduler.rs:677). The engine decodes a fixed batch of slots, so the
scheduler also assigns and releases slot indices in [0, max_batch).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..kv.manager import KVCacheManager
from .sequence import Sequence, SequenceState, StopReason


@dataclass
class ScheduledPrefill:
    seq: Sequence
    start: int  # first logical token position of this chunk
    length: int  # chunk token count
    cached: int  # tokens served from prefix cache (first chunk only)


@dataclass
class SchedulerOutput:
    prefills: list[ScheduledPrefill] = field(default_factory=list)
    decode: list[Sequence] = field(default_factory=list)
    preempted: list[Sequence] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decode


class Scheduler:
    def __init__(
        self,
        kv: KVCacheManager,
        max_batch: int,
        prefill_chunk: int = 1024,
        enable_prefix_caching: bool = True,
        groups: int = 1,  # data-parallel groups; slots are group-major
        max_prefill_seqs: int = 4,  # prompt chunks batched into one step
    ):
        self.kv = kv
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.max_prefill_seqs = max_prefill_seqs
        # tokens to allocate ahead per decode round (speculative: gamma+1)
        self.lookahead = 1
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        self.groups = groups
        if max_batch % groups:
            raise ValueError(f"max_batch {max_batch} not divisible by {groups} groups")
        self.slots_per_group = max_batch // groups
        # per-group free-slot stacks; slot g*spg+i belongs to group g (the
        # batch axis shards contiguously over the data mesh axis)
        self._free_slots = [
            list(range((g + 1) * self.slots_per_group - 1,
                       g * self.slots_per_group - 1, -1))
            for g in range(groups)
        ]
        self.num_preemptions = 0
        # engine hook called on recompute-preemption with (seq, folded_ids):
        # multimodal sequences must extend prompt_embeds to cover generated
        # tokens folded into the prompt, or re-prefill shape-errors
        self.on_preempt = None

    # -- queue ops -----------------------------------------------------------

    def add(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def abort(self, request_id: str) -> Optional[Sequence]:
        for q in (self.waiting, self.running):
            for s in list(q):
                if s.request_id == request_id:
                    self._remove(s)
                    s.finish(StopReason.CANCELLED)
                    return s
        return None

    def _push_slot(self, slot: int) -> None:
        self._free_slots[slot // self.slots_per_group].append(slot)

    def _groups_with_free_slots(self) -> list[int]:
        return [g for g in range(self.groups) if self._free_slots[g]]

    def _remove(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
            if seq.slot is not None:
                self._push_slot(seq.slot)
                seq.slot = None
            self.kv.free(seq.request_id)
        elif seq in self.waiting:
            self.waiting.remove(seq)
            if seq.slot is not None:  # slot is claimed at admission
                self._push_slot(seq.slot)
                seq.slot = None
            if seq.num_computed_tokens > 0:  # mid-prefill abort holds blocks
                self.kv.free(seq.request_id)

    def release(self, seq: Sequence) -> None:
        """Free resources of a finished sequence."""
        self._remove(seq)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- core ----------------------------------------------------------------

    def schedule(self) -> SchedulerOutput:
        """One engine step: decode the whole running batch AND advance up to
        ``max_prefill_seqs`` prompt chunks (mixed prefill+decode steps — the
        reference schedules prompt batches and completions concurrently,
        `default_scheduler.rs:201`; one long prompt no longer stalls all
        decoding)."""
        out = SchedulerOutput()
        self._step_preempted: set[int] = set()

        # 1. decode the running batch (first: its block claims win, and the
        # engine runs the latency-sensitive decode forward before prefill)
        if self.running:
            # ensure every running sequence has a slot for its next token
            for seq in list(self.running):
                if seq not in self.running:
                    continue  # evicted as a victim by an earlier iteration
                need = seq.total_len + self.lookahead
                ok = self.kv.allocate_slots(seq.request_id, need)
                if not ok:
                    ok = self._preempt_for(seq, need, exclude=seq)
                if not ok:
                    # cannot even preempt (seq is lowest priority) → preempt it
                    self._preempt(seq)
                    out.preempted.append(seq)
            out.decode = [s for s in self.running]

        # 2. admit / continue prefilling waiting sequences (FCFS; stop at the
        # first admission failure to preserve arrival order). Sequences
        # preempted THIS step wait until the next one (re-admitting them now
        # could bounce them to the back of the queue).
        touched: set[int] = {id(s) for s in out.preempted} | self._step_preempted
        while self.waiting and len(out.prefills) < self.max_prefill_seqs:
            seq = self.waiting[0]
            if id(seq) in touched:
                break  # mid-prefill continuation or fresh preemptee: next step
            if seq.slot is None:  # fresh admission needs a slot in some group
                free_groups = self._groups_with_free_slots()
                if not free_groups:
                    break
            # pop AFTER the guards: preemption appendlefts victims onto
            # `waiting`, and a failed admission goes to the back
            self.waiting.popleft()
            touched.add(id(seq))
            start = seq.num_computed_tokens
            if start == 0:
                # pin the sequence to a DP group (trivially group 0 when
                # groups == 1) before any block accounting
                self.kv.assign_group(seq.request_id, allowed=free_groups)
                # claim the decode slot at ADMISSION (not prompt completion):
                # hybrid archs key per-sequence recurrent/conv state pools by
                # slot, so chunked prefill needs a stable slot from chunk 0
                g0 = self.kv.group_of(seq.request_id)
                seq.slot = self._free_slots[g0].pop()
                cached = self.kv.get_computed_blocks(
                    seq.request_id, seq.prompt_ids, extra=seq.extra_hash
                )
                start = cached
                seq.num_computed_tokens = cached
            else:
                cached = 0
            length = min(self.prefill_chunk, seq.prompt_len - start)
            ok = self.kv.allocate_slots(seq.request_id, start + length)
            if not ok:
                # admission may only displace strictly lower-priority /
                # later-arrival runners — prevents admit/decode ping-pong
                ok = self._preempt_for(seq, start + length, beneath=seq)
                touched |= self._step_preempted  # victims wait for next step
            if not ok:
                # cannot admit now — put it back behind any preempted victims.
                # A fresh sequence (nothing computed) gives up its slot so it
                # cannot starve runnable work from the back of the queue; a
                # mid-prefill one keeps slot+blocks (its state is live).
                if seq.num_computed_tokens == 0 and seq.slot is not None:
                    self._push_slot(seq.slot)
                    seq.slot = None
                self.waiting.append(seq)
                break
            if seq.state == SequenceState.WAITING:
                seq.state = SequenceState.RUNNING
            out.prefills.append(ScheduledPrefill(seq, start, length, cached))
            seq.num_computed_tokens = start + length
            if start + length >= seq.prompt_len:
                # prompt complete → joins the decode batch NEXT step (this
                # step's decode list was fixed above; slot was claimed at
                # admission)
                self.running.append(seq)
            else:
                # more chunks to go: stays at the head of waiting
                self.waiting.appendleft(seq)

        # drop decode members that admission preempted after the list was made
        # (membership check, NOT length — a preemption and a prompt completion
        # in the same step leave the lengths equal while the contents differ)
        if out.decode:
            live = {id(s) for s in self.running}
            out.decode = [s for s in out.decode if id(s) in live]

        # stall guard: nothing runnable, yet queued sequences hold slots or
        # blocks (mid-prefill casualties of pool pressure). Reset their
        # claims so FCFS can make progress from a clean pool.
        if out.is_empty and not self.running and self.waiting:
            freed = False
            for s in list(self.waiting):
                if s.slot is not None or s.num_computed_tokens > 0:
                    if s.slot is not None:
                        self._push_slot(s.slot)
                        s.slot = None
                    if s.num_computed_tokens > 0:
                        self.kv.free(s.request_id)
                        s.num_computed_tokens = 0
                    freed = True
            if freed:
                return self.schedule()
        return out

    # -- preemption ----------------------------------------------------------

    def _victims(
        self,
        exclude: Optional[Sequence],
        beneath: Optional[Sequence] = None,
        group: Optional[int] = None,
    ) -> list[Sequence]:
        """Lowest priority, then latest arrival first (scheduler.rs:677).
        With ``beneath``, only sequences strictly below it qualify. Victims
        must share the claimant's DP group (each group's block pool is
        independent)."""
        cands = [s for s in self.running if s is not exclude]
        if group is not None and self.groups > 1:
            cands = [s for s in cands if self.kv.group_of(s.request_id) == group]
        if beneath is not None:
            cands = [
                s for s in cands
                if (s.priority, -s.arrival_time) < (beneath.priority, -beneath.arrival_time)
            ]
        return sorted(cands, key=lambda s: (s.priority, -s.arrival_time))

    def _preempt(self, seq: Sequence) -> None:
        self.num_preemptions += 1
        if not hasattr(self, "_step_preempted"):
            self._step_preempted = set()
        self._step_preempted.add(id(seq))
        if seq in self.running:
            self.running.remove(seq)
        if seq.slot is not None:
            self._push_slot(seq.slot)
            seq.slot = None
        self.kv.free(seq.request_id)
        # recompute-from-scratch preemption: generated tokens fold into the
        # prompt so prefill replays them (reference: preempt_by_recompute)
        if self.on_preempt is not None and seq.output_ids:
            self.on_preempt(seq, list(seq.output_ids))
        seq.prompt_ids = seq.all_ids
        seq.output_ids = []
        seq.num_computed_tokens = 0
        seq.state = SequenceState.WAITING
        self.waiting.appendleft(seq)

    def _preempt_for(
        self,
        seq: Sequence,
        needed_tokens: int,
        exclude: Optional[Sequence] = None,
        beneath: Optional[Sequence] = None,
    ) -> bool:
        """Evict victims until `seq` can allocate. Returns success."""
        victims = self._victims(exclude, beneath,
                                group=self.kv.group_of(seq.request_id))
        while victims:
            if self.kv.allocate_slots(seq.request_id, needed_tokens):
                return True
            self._preempt(victims.pop(0))  # best victim first
        return self.kv.allocate_slots(seq.request_id, needed_tokens)
