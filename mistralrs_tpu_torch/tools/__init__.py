"""Tool-calling and reasoning output parsing (a copy of
``mistralrs_tpu/tools/``; the analog of `mistralrs-core/src/tools/` and
`src/reasoning_parsers/`). Plain Python on the host."""

from .parsers import ToolCall, ToolCallingMatcher, parse_tool_calls
from .reasoning import ReasoningParser, split_reasoning

__all__ = [
    "ToolCall",
    "ToolCallingMatcher",
    "parse_tool_calls",
    "ReasoningParser",
    "split_reasoning",
]
