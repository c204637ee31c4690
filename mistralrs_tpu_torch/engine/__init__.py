"""Continuous-batching engine over the paged KV cache."""

from .engine import Engine
from .sampler import SamplingParams
from .sequence import Sequence, SequenceState, StopReason

__all__ = ["Engine", "SamplingParams", "Sequence", "SequenceState", "StopReason"]
