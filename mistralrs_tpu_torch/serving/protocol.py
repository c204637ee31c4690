"""OpenAI wire types for the chat route (counterpart of
``mistralrs_tpu/serving/protocol.py``), on the standard library: requests are
validated by hand instead of with pydantic, which the card's machine lacks.
Response dictionaries follow the JAX server's schema."""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

#: request fields the JAX server honours that this port does not yet
UNSUPPORTED_CHAT_FIELDS = (
    "tools", "tool_choice", "response_format", "grammar", "adapters",
    "dry_multiplier", "dry_base", "dry_allowed_length", "dry_sequence_breakers",
)


@dataclass
class ChatMessage:
    role: str
    content: Any = None  # str or a list of {"type": "text", "text": ...} parts

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        parts = []
        for p in self.content:
            if not isinstance(p, dict) or p.get("type") != "text":
                raise ValueError(f"message part {p!r}: only text parts are supported")
            parts.append(str(p.get("text", "")))
        return "".join(parts)


@dataclass
class ChatCompletionRequest:
    messages: list[ChatMessage]
    model: str = "default"
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    stream: bool = False
    stop: Any = None  # str or list[str]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[dict[str, float]] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    user: Optional[str] = None

    @classmethod
    def parse(cls, body: Any) -> "ChatCompletionRequest":
        """Validate a decoded JSON body; raises ValueError on a bad request
        and NotImplementedError on a field this server does not serve."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not msgs:
            raise ValueError("'messages' must be a non-empty list")
        messages = []
        for m in msgs:
            if not isinstance(m, dict) or not isinstance(m.get("role"), str):
                raise ValueError(f"bad message {m!r}")
            messages.append(ChatMessage(m["role"], m.get("content")))
        for key in UNSUPPORTED_CHAT_FIELDS:
            if body.get(key) is not None:
                raise NotImplementedError(f"'{key}' is not supported by this server")
        if body.get("n", 1) != 1:
            raise NotImplementedError("only n = 1 is supported")
        kinds = {
            "model": str, "temperature": (int, float), "top_p": (int, float),
            "top_k": int, "min_p": (int, float), "stream": bool,
            "max_tokens": int, "max_completion_tokens": int,
            "presence_penalty": (int, float), "frequency_penalty": (int, float),
            "repetition_penalty": (int, float), "logit_bias": dict, "logprobs": bool,
            "top_logprobs": int, "seed": int, "user": str, "stop": (str, list),
        }
        kw = {}
        for key, kind in kinds.items():
            v = body.get(key)
            if v is None:
                continue
            if not isinstance(v, kind) or (kind is int and isinstance(v, bool)):
                raise ValueError(f"'{key}' has the wrong type: {v!r}")
            kw[key] = v
        return cls(messages=messages, **kw)


def now() -> int:
    return int(time.time())


def gen_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def chat_completion_response(
    model: str, text: str, finish_reason: str, usage: dict[str, int],
    logprobs: Optional[dict] = None,
) -> dict:
    return {
        "id": gen_id("chatcmpl"),
        "object": "chat.completion",
        "created": now(),
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish_reason,
                "logprobs": logprobs,
            }
        ],
        "usage": usage,
    }


def chat_chunk(model: str, rid: str, delta: dict, finish_reason=None) -> dict:
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": now(),
        "model": model,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish_reason}],
    }
