"""Per-family tool-call parsers (a copy of ``mistralrs_tpu/tools/parsers.py``;
the analog of `ToolCallingMatcher`
`mistralrs-core/src/tools/mod.rs:38` + `src/tools/parsers/{llama,
mistral_nemo,qwen,deepseek,...}.rs`).

Each parser extracts structured calls from a model-family's emission style;
`auto` tries the family parser for the arch, then falls back to bare-JSON
detection (the reference's behavior for untagged outputs).
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ToolCall:
    name: str
    arguments: dict[str, Any]
    id: str = field(default_factory=lambda: f"call_{uuid.uuid4().hex[:12]}")

    def to_openai(self) -> dict:
        return {
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": json.dumps(self.arguments)},
        }


def _try_json(text: str) -> Optional[Any]:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return None


def _calls_from_obj(obj: Any) -> list[ToolCall]:
    """Normalize a decoded JSON object/array into tool calls."""
    items = obj if isinstance(obj, list) else [obj]
    out = []
    for it in items:
        if not isinstance(it, dict):
            return []
        name = it.get("name")
        args = it.get("arguments", it.get("parameters", {}))
        if isinstance(args, str):
            args = _try_json(args) or {}
        if not isinstance(name, str) or not isinstance(args, dict):
            return []
        out.append(ToolCall(name=name, arguments=args))
    return out


def _scan_json_objects(text: str) -> list[Any]:
    """Find balanced top-level {...} / [...] spans and decode them."""
    objs = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "{[":
            depth = 0
            in_str = False
            esc = False
            for j in range(i, n):
                ch = text[j]
                if in_str:
                    if esc:
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        in_str = False
                elif ch == '"':
                    in_str = True
                elif ch in "{[":
                    depth += 1
                elif ch in "}]":
                    depth -= 1
                    if depth == 0:
                        obj = _try_json(text[i : j + 1])
                        if obj is not None:
                            objs.append(obj)
                        i = j
                        break
            i += 1
        else:
            i += 1
    return objs


# --- family parsers ---------------------------------------------------------


def parse_llama(text: str) -> list[ToolCall]:
    """Llama-3 style: bare JSON `{"name": .., "parameters": ..}` (optionally
    after `<|python_tag|>`), or `;`-separated multiple calls."""
    text = text.replace("<|python_tag|>", " ").strip()
    calls: list[ToolCall] = []
    for part in re.split(r";(?=\s*\{)", text):
        for obj in _scan_json_objects(part):
            calls.extend(_calls_from_obj(obj))
    return calls


def parse_mistral(text: str) -> list[ToolCall]:
    """Mistral-Nemo style: `[TOOL_CALLS][{...}, ...]`."""
    m = re.search(r"\[TOOL_CALLS\]\s*(\[.*)", text, re.DOTALL)
    if not m:
        return []
    objs = _scan_json_objects(m.group(1))
    return _calls_from_obj(objs[0]) if objs else []


def parse_qwen(text: str) -> list[ToolCall]:
    """Hermes/Qwen style: `<tool_call>{...}</tool_call>` blocks."""
    calls = []
    for m in re.finditer(r"<tool_call>\s*(.*?)\s*</tool_call>", text, re.DOTALL):
        obj = _try_json(m.group(1))
        if obj is not None:
            calls.extend(_calls_from_obj(obj))
    return calls


def parse_deepseek(text: str) -> list[ToolCall]:
    """DeepSeek style: tool-call special-token sandwich with json body."""
    pat = (
        r"<｜tool▁call▁begin｜>.*?<｜tool▁sep｜>(\w+)\s*\n```json\n(.*?)\n```"
    )
    calls = []
    for m in re.finditer(pat, text, re.DOTALL):
        args = _try_json(m.group(2))
        if isinstance(args, dict):
            calls.append(ToolCall(name=m.group(1), arguments=args))
    if calls:
        return calls
    return parse_qwen(text)


def parse_gemma(text: str) -> list[ToolCall]:
    """Gemma style: ```tool_code / json fenced blocks or bare json."""
    calls = []
    for m in re.finditer(r"```(?:tool_code|json)?\s*(.*?)```", text, re.DOTALL):
        for obj in _scan_json_objects(m.group(1)):
            calls.extend(_calls_from_obj(obj))
    if calls:
        return calls
    return parse_llama(text)


def parse_hunyuan(text: str) -> list[ToolCall]:
    """Hunyuan style: `<tool_calls>[{"name":..,"arguments":..}]</tool_calls>`
    (parsers/hunyuan.rs)."""
    calls = []
    for m in re.finditer(r"<tool_calls>\s*(.*?)\s*</tool_calls>", text, re.DOTALL):
        obj = _try_json(m.group(1))
        if obj is not None:
            calls.extend(_calls_from_obj(obj))
    return calls


def parse_liquid(text: str) -> list[ToolCall]:
    """Liquid/LFM style: pythonic call list
    `<|tool_call_start|>[get_weather(location="Paris")]<|tool_call_end|>`
    (parsers/liquid.rs)."""
    import ast

    calls: list[ToolCall] = []
    for m in re.finditer(
        r"<\|tool_call_start\|>\s*(.*?)\s*<\|tool_call_end\|>", text, re.DOTALL
    ):
        body = m.group(1)
        try:
            tree = ast.parse(body, mode="eval")
        except SyntaxError:
            continue
        nodes = (
            tree.body.elts if isinstance(tree.body, ast.List) else [tree.body]
        )
        for node in nodes:
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
                continue
            args: dict[str, Any] = {}
            ok = True
            for kw in node.keywords:
                if kw.arg is None:
                    ok = False
                    break
                try:
                    args[kw.arg] = ast.literal_eval(kw.value)
                except (ValueError, SyntaxError):
                    ok = False
                    break
            if ok:
                calls.append(ToolCall(name=node.func.id, arguments=args))
    return calls


def parse_gemma4(text: str) -> list[ToolCall]:
    """Gemma 4 strict style:
    `<|tool_call>call:NAME{key:<|"|>value<|"|>,key2:42}<tool_call|>`
    (parsers/gemma4.rs) — string values use the <|"|> delimiter."""
    calls = []
    for m in re.finditer(
        r"<\|tool_call>call:([\w.-]+)\{(.*?)\}<tool_call\|>", text, re.DOTALL
    ):
        name, body = m.group(1), m.group(2)
        args: dict[str, Any] = {}
        # tokenize: key : (<|"|>str<|"|> | literal) separated by commas
        pos = 0
        ok = True
        pair = re.compile(
            r"\s*([\w.-]+)\s*:\s*(?:<\|\"\|>(.*?)<\|\"\|>|([^,]*))\s*(?:,|$)",
            re.DOTALL,
        )
        while pos < len(body):
            pm = pair.match(body, pos)
            if not pm:
                ok = False
                break
            key, sval, lit = pm.group(1), pm.group(2), pm.group(3)
            if sval is not None:
                args[key] = sval
            else:
                v = _try_json(lit.strip())
                args[key] = v if v is not None else lit.strip()
            pos = pm.end()
        if ok:
            calls.append(ToolCall(name=name, arguments=args))
    return calls


def parse_harmony(text: str) -> list[ToolCall]:
    """Harmony (gpt-oss) channel format:
    `<|channel|>commentary to=functions.NAME <|constrain|>json<|message|>{..}<|call|>`
    (parsers/harmony.rs; detected at token level in the reference — here on
    the detokenized text, which round-trips the same special tokens)."""
    pat = (
        r"<\|channel\|>\s*commentary\s+to=(?:functions\.)?([\w.-]+).*?"
        r"<\|message\|>(.*?)(?:<\|call\|>|$)"
    )
    calls = []
    for m in re.finditer(pat, text, re.DOTALL):
        args = _try_json(m.group(2).strip())
        if isinstance(args, dict):
            calls.append(ToolCall(name=m.group(1), arguments=args))
    return calls


_PARSERS = {
    "llama": parse_llama,
    "mistral": parse_mistral,
    "mistral_nemo": parse_mistral,
    "qwen": parse_qwen,
    "qwen2": parse_qwen,
    "qwen3": parse_qwen,
    "hermes": parse_qwen,
    "deepseek": parse_deepseek,
    "gemma": parse_gemma,
    "gemma2": parse_gemma,
    "gemma3": parse_gemma,
    "gemma4": parse_gemma4,
    "hunyuan": parse_hunyuan,
    "hunyuan_moe": parse_hunyuan,
    "liquid": parse_liquid,
    "lfm2": parse_liquid,
    "harmony": parse_harmony,
    "gpt_oss": parse_harmony,
}


def parse_tool_calls(text: str, family: str = "auto") -> list[ToolCall]:
    if family != "auto":
        fn = _PARSERS.get(family)
        if fn is None:
            raise ValueError(f"unknown tool parser family {family!r}")
        return fn(text)
    for fn in (parse_qwen, parse_mistral, parse_deepseek, parse_hunyuan,
               parse_liquid, parse_gemma4, parse_harmony, parse_llama):
        calls = fn(text)
        if calls:
            return calls
    return []


class ToolCallingMatcher:
    """Stateful matcher used by the engine/server: decides whether an output
    is a tool call and extracts the calls (mod.rs:38 analog)."""

    def __init__(self, family: str = "auto", tool_choice: str = "auto"):
        self.family = family
        self.tool_choice = tool_choice

    def get_calls(self, text: str) -> list[ToolCall]:
        if self.tool_choice == "none":
            return []
        return parse_tool_calls(text, self.family)

    def prefix_could_be_tool(self, text: str) -> bool:
        """Streaming gate: does this prefix look like it may become a call?"""
        t = text.lstrip()
        starts = ("{", "[", "<tool_call>", "[TOOL_CALLS]", "```",
                  "<|python_tag|>", "<tool_calls>", "<|tool_call_start|>",
                  "<|tool_call>", "<|channel|>")
        return any(s.startswith(t) or t.startswith(s) for s in starts)
