"""Per-request decode state (a copy of ``mistralrs_tpu/engine/sequence.py``;
the analog of the reference's `Sequence`, `mistralrs-core/src/sequence.rs:668`,
trimmed to the text-serving core)."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from .sampler import SamplingParams


class SequenceState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


class StopReason(enum.Enum):
    NOT_DONE = "not_done"
    EOS = "eos"
    STOP_TOKEN = "stop_token"
    STOP_STRING = "stop_string"
    LENGTH = "length"
    CANCELLED = "cancelled"
    ERROR = "error"


@dataclass
class Sequence:
    request_id: str
    prompt_ids: list[int]
    params: SamplingParams
    arrival_time: float = field(default_factory=time.monotonic)
    state: SequenceState = SequenceState.WAITING
    output_ids: list[int] = field(default_factory=list)
    output_logprobs: list[float] = field(default_factory=list)
    output_top_logprobs: list[dict] = field(default_factory=list)
    num_computed_tokens: int = 0  # prompt tokens already prefilled into KV
    stop_reason: StopReason = StopReason.NOT_DONE
    slot: Optional[int] = None  # engine batch slot while RUNNING
    priority: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # streaming sink: callable(list[int] new_tokens, bool finished)
    on_tokens: Optional[Any] = None
    # incremental detokenization bookkeeping (set by the engine)
    detok_prefix_len: int = 0
    emitted_text_len: int = 0
    # content digest chained into block hashes (multimodal prompts repeat
    # placeholder token ids — token-only hashes would collide across images)
    extra_hash: tuple = ()
    # seed of the sampler's draws: the request's, or one the engine derives
    sample_seed: int = 0
    # grammar constraint (the engine's resolved recognizer) and its state
    # after the committed tokens; kept across preemption-recompute, so a
    # recomputed request resumes where its output left the recognizer
    constraint: Any = None
    constraint_state: Any = None
    constraint_done: bool = False  # the output completed the constraint
    # set in __post_init__; stable across preemption-recompute (which folds
    # generated tokens back into prompt_ids)
    original_prompt_len: int = -1

    def __post_init__(self):
        if self.original_prompt_len < 0:
            self.original_prompt_len = len(self.prompt_ids)

    @property
    def all_ids(self) -> list[int]:
        return self.prompt_ids + self.output_ids

    @property
    def generated_ids(self) -> list[int]:
        """All generated tokens, robust to preemption-recompute."""
        return self.all_ids[self.original_prompt_len :]

    @property
    def num_generated(self) -> int:
        return self.total_len - self.original_prompt_len

    @property
    def total_len(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def is_finished(self) -> bool:
        return self.state == SequenceState.FINISHED

    def finish(self, reason: StopReason) -> None:
        self.state = SequenceState.FINISHED
        self.stop_reason = reason
        self.finish_time = time.monotonic()
