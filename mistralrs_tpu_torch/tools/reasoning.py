"""Reasoning-tag parsing (a copy of ``mistralrs_tpu/tools/reasoning.py``; the
analog of
`mistralrs-core/src/reasoning_parsers/tag_based.rs`): split `<think>...`
content from the final answer, with incremental streaming support."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT_TAGS = [("<think>", "</think>"), ("<thinking>", "</thinking>")]


def split_reasoning(
    text: str, tags=None
) -> tuple[Optional[str], str]:
    """→ (reasoning or None, content). Handles a missing-open-tag model
    (some emit the close tag only) and unterminated reasoning."""
    for open_t, close_t in tags or DEFAULT_TAGS:
        if text.lstrip().startswith(open_t):
            body = text.lstrip()[len(open_t):]
            if close_t in body:
                reasoning, content = body.split(close_t, 1)
                return reasoning.strip(), content.lstrip("\n")
            return body.strip(), ""
        if close_t in text and open_t not in text:
            reasoning, content = text.split(close_t, 1)
            return reasoning.strip(), content.lstrip("\n")
    return None, text


@dataclass
class ReasoningParser:
    """Incremental splitter for streaming: feed deltas, get
    (reasoning_delta, content_delta) pairs."""

    open_tag: str = "<think>"
    close_tag: str = "</think>"
    _buffer: str = ""
    _state: str = "start"  # start | reasoning | content

    def push(self, delta: str) -> tuple[str, str]:
        self._buffer += delta
        r_out, c_out = "", ""
        while True:
            if self._state == "start":
                stripped = self._buffer.lstrip()
                if not stripped:
                    return r_out, c_out
                if self.open_tag.startswith(stripped) or stripped.startswith(
                    self.open_tag
                ):
                    if stripped.startswith(self.open_tag):
                        self._buffer = stripped[len(self.open_tag):]
                        self._state = "reasoning"
                        continue
                    return r_out, c_out  # possible partial open tag — hold
                self._state = "content"
                continue
            if self._state == "reasoning":
                idx = self._buffer.find(self.close_tag)
                if idx >= 0:
                    r_out += self._buffer[:idx]
                    self._buffer = self._buffer[idx + len(self.close_tag):].lstrip("\n")
                    self._state = "content"
                    continue
                # emit all but a potential partial close tag
                hold = 0
                for i in range(1, len(self.close_tag)):
                    if self._buffer.endswith(self.close_tag[:i]):
                        hold = i
                r_out += self._buffer[: len(self._buffer) - hold]
                self._buffer = self._buffer[len(self._buffer) - hold:]
                return r_out, c_out
            # content
            c_out += self._buffer
            self._buffer = ""
            return r_out, c_out

    def flush(self) -> tuple[str, str]:
        out = self._buffer
        self._buffer = ""
        if self._state == "reasoning":
            return out, ""
        return "", out
