"""OpenAI and Anthropic wire types (counterpart of
``mistralrs_tpu/serving/protocol.py``), on the standard library: requests are
validated by hand instead of with pydantic, which the card's machine lacks
(each field's type as the JAX model declares it; a bad body raises
``ValueError``, HTTP 422). Response dictionaries follow the JAX server's
schema."""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

#: request fields the JAX server honours that this port does not yet
#: (``adapters`` selects LoRA adapters, which are not ported)
UNSUPPORTED_CHAT_FIELDS = ("adapters",)

_NUM = (int, float)


def _fields(body: dict, kinds: dict) -> dict:
    """The fields of ``kinds`` present (not null) in ``body``, each checked
    against its type (a bool is not an int)."""
    kw = {}
    for key, kind in kinds.items():
        v = body.get(key)
        if v is None:
            continue
        if not isinstance(v, kind) or (isinstance(v, bool) and bool not in (
                kind if isinstance(kind, tuple) else (kind,))):
            raise ValueError(f"'{key}' has the wrong type: {v!r}")
        kw[key] = v
    return kw


def _str_list(v) -> bool:
    return isinstance(v, list) and all(isinstance(x, str) for x in v)


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
    tools: Optional[list[dict]] = None
    tool_choice: Any = None  # str or dict
    response_format: Optional[dict] = None
    # reference extension (`mistralrs-server-core` Grammar): constrained
    # decoding — {"type": "regex"|"lark"|"json_schema"|"choice", "value": ...}
    grammar: Optional[dict] = None
    # DRY repetition penalty (reference sampler extension)
    dry_multiplier: Optional[float] = None
    dry_base: Optional[float] = None
    dry_allowed_length: Optional[int] = None
    dry_sequence_breakers: Optional[list[int]] = None
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
        kw = _fields(body, {
            "model": str, "temperature": _NUM, "top_p": _NUM,
            "top_k": int, "min_p": _NUM, "stream": bool,
            "max_tokens": int, "max_completion_tokens": int,
            "presence_penalty": _NUM, "frequency_penalty": _NUM,
            "repetition_penalty": _NUM, "logit_bias": dict, "logprobs": bool,
            "top_logprobs": int, "seed": int, "user": str, "stop": (str, list),
            "tools": list, "tool_choice": (str, dict), "response_format": dict,
            "grammar": dict, "dry_multiplier": _NUM, "dry_base": _NUM,
            "dry_allowed_length": int, "dry_sequence_breakers": list,
        })
        if not all(isinstance(t, dict) for t in kw.get("tools", [])):
            raise ValueError("'tools' must be a list of objects")
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   for t in kw.get("dry_sequence_breakers", [])):
            raise ValueError("'dry_sequence_breakers' must be a list of token ids")
        return cls(messages=messages, **kw)


@dataclass
class CompletionRequest:
    prompt: Any  # str, list[str] or list[int]
    model: str = "default"
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    stream: bool = False
    stop: Any = None  # str or list[str]
    max_tokens: Optional[int] = 16
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    seed: Optional[int] = None
    echo: bool = False

    @classmethod
    def parse(cls, body: Any) -> "CompletionRequest":
        """Validate a decoded JSON body (``n`` and ``stream`` are read and
        ignored, as the JAX route ignores them)."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        prompt = body.get("prompt")
        if not (isinstance(prompt, str) or _str_list(prompt) or (
                isinstance(prompt, list) and all(
                    isinstance(x, int) and not isinstance(x, bool) for x in prompt))):
            raise ValueError("'prompt' must be a string, a list of strings or a list of "
                             "token ids")
        kw = _fields(body, {
            "model": str, "temperature": _NUM, "top_p": _NUM, "top_k": int, "n": int,
            "stream": bool, "stop": (str, list), "max_tokens": int,
            "presence_penalty": _NUM, "frequency_penalty": _NUM, "seed": int, "echo": bool,
        })
        return cls(prompt=prompt, **kw)


@dataclass
class AnthropicMessagesRequest:
    messages: list[dict]
    model: str = "default"
    system: Any = None  # str or a list of {"type": "text", "text": ...}
    max_tokens: int = 1024
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stop_sequences: Optional[list[str]] = None
    stream: bool = False
    metadata: Optional[dict] = None

    @classmethod
    def parse(cls, body: Any) -> "AnthropicMessagesRequest":
        """Validate a decoded JSON body (``stream`` is read and ignored, as
        the JAX route ignores it)."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not all(
                isinstance(m, dict) and isinstance(m.get("role"), str) for m in msgs):
            raise ValueError("'messages' must be a list of objects with a 'role'")
        kw = _fields(body, {
            "model": str, "system": (str, list), "max_tokens": int, "temperature": _NUM,
            "top_p": _NUM, "top_k": int, "stop_sequences": list, "stream": bool,
            "metadata": dict,
        })
        if "stop_sequences" in kw and not _str_list(kw["stop_sequences"]):
            raise ValueError("'stop_sequences' must be a list of strings")
        return cls(messages=msgs, **kw)


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


def completion_response(
    model: str, text: str, finish_reason: str, usage: dict[str, int]
) -> dict:
    return {
        "id": gen_id("cmpl"),
        "object": "text_completion",
        "created": now(),
        "model": model,
        "choices": [
            {"index": 0, "text": text, "finish_reason": finish_reason, "logprobs": None}
        ],
        "usage": usage,
    }


def anthropic_response(model: str, text: str, stop_reason: str, usage: dict) -> dict:
    return {
        "id": gen_id("msg"),
        "type": "message",
        "role": "assistant",
        "model": model,
        "content": [{"type": "text", "text": text}],
        "stop_reason": stop_reason,
        "stop_sequence": None,
        "usage": usage,
    }
