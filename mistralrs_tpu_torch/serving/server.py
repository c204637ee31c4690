"""OpenAI- and Anthropic-compatible HTTP server on the standard library
(counterpart of ``mistralrs_tpu/serving/server.py``, which is built on
aiohttp): its text-serving routes, with the JSON of the JAX server's.

Routes:

* ``GET /health``, ``GET /v1/models``, ``GET /v1/system/info`` (torch's
  device name where the JAX server gives its backend), ``GET /metrics``
  (Prometheus text: request counters, in-flight gauge, durations, the
  default engine's stats);
* ``POST /v1/chat/completions`` (blocking, or Server-Sent Events with
  ``"stream": true``): ``response_format`` (``json_object``,
  ``json_schema``) and ``grammar`` (``regex``, ``lark``, ``choice``,
  ``json_schema``) become grammar constraints and the ``dry_*`` fields the
  DRY penalty; ``tools`` are rendered into the chat template and a blocking
  answer's tool calls come back as ``tool_calls`` (``finish_reason``
  ``"tool_calls"``), its ``<think>`` text as ``reasoning_content``;
* ``POST /v1/completions``, ``POST /v1/messages`` and
  ``/v1/messages/count_tokens``, ``POST /v1/embeddings``, ``POST
  /v1/responses`` with ``GET``/``DELETE /v1/responses/{id}`` (kept in
  memory), ``POST /v1/models/load``, ``/unload`` and ``/reload``.

``http.server.ThreadingHTTPServer`` handles each connection on its own
thread; each model's engine thread (``registry.py``) steps its engine and
hands tokens to the request threads through queues.

``Server.start()`` serves from a background thread (tests, the card's smoke
run); ``Server.shutdown()`` stops the HTTP loop, closes the socket and joins
the server and engine threads. On the CPU (``Engine(..., device="cpu")``)::

    curl -s localhost:8080/v1/completions -d '{"prompt": "Hi", "max_tokens": 8}'
    curl -s localhost:8080/v1/chat/completions -d '{"messages": [{"role": "user",
         "content": "Hi"}], "response_format": {"type": "json_object"}}'
"""

from __future__ import annotations

import functools
import json
import platform
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

import torch

from ..chat_template import ChatTemplate
from ..engine.engine import Engine
from ..engine.sampler import SamplingParams
from ..engine.sequence import StopReason
from ..grammar import ChoiceConstraint
from ..tools import ToolCallingMatcher, split_reasoning
from . import protocol as P
from .registry import ModelInstance, ModelRegistry

_FINISH_MAP = {
    StopReason.EOS: "stop",
    StopReason.STOP_TOKEN: "stop",
    StopReason.STOP_STRING: "stop",
    StopReason.LENGTH: "length",
    StopReason.CANCELLED: "abort",
    StopReason.ERROR: "error",
}
_ANTHROPIC_STOP = {
    StopReason.EOS: "end_turn",
    StopReason.STOP_TOKEN: "end_turn",
    StopReason.LENGTH: "max_tokens",
    StopReason.STOP_STRING: "stop_sequence",
}
# archs with a tool-call parser of their own (JAX server.py:540-543)
_TOOL_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "gemma2", "gemma3")

#: longest a request thread waits for the engine between two token batches
TOKEN_TIMEOUT_S = 600.0


class Metrics:
    """Prometheus text-format counters (a copy of the JAX server's; the
    reference's ``metrics.rs``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests_total: dict[tuple[str, str, int], int] = {}
        self.in_flight = 0
        self.request_seconds_sum = 0.0
        self.request_seconds_count = 0

    def begin(self) -> None:
        with self.lock:
            self.in_flight += 1

    def observe(self, method: str, route: str, status: int, dt: float):
        with self.lock:
            self.in_flight -= 1
            key = (method, route, status)
            self.requests_total[key] = self.requests_total.get(key, 0) + 1
            self.request_seconds_sum += dt
            self.request_seconds_count += 1

    def render(self, engine_stats: dict) -> str:
        lines = [
            "# TYPE http_requests_total counter",
        ]
        with self.lock:
            for (m, r, s), v in sorted(self.requests_total.items()):
                lines.append(
                    f'http_requests_total{{method="{m}",route="{r}",status="{s}"}} {v}'
                )
            lines.append("# TYPE http_requests_in_flight gauge")
            lines.append(f"http_requests_in_flight {self.in_flight}")
            lines.append("# TYPE http_request_duration_seconds summary")
            lines.append(f"http_request_duration_seconds_sum {self.request_seconds_sum}")
            lines.append(
                f"http_request_duration_seconds_count {self.request_seconds_count}"
            )
        for k, v in engine_stats.items():
            lines.append(f"# TYPE engine_{k} counter")
            lines.append(f"engine_{k} {v}")
        return "\n".join(lines) + "\n"


@functools.lru_cache(maxsize=64)
def _choice_constraint(choices: tuple) -> ChoiceConstraint:
    """One recognizer for the requests that give the same choices (they
    share its transition table in the engine's mask builder)."""
    return ChoiceConstraint(list(choices))


def _constraint_from_chat(req: P.ChatCompletionRequest):
    """``response_format`` / ``grammar`` → the engine's constraint (JAX
    ``_sampling_from_chat``, server.py:186-201): ``grammar`` wins."""
    constraint = None
    rf = req.response_format or {}
    if rf.get("type") in ("json_object", "json_schema"):
        # json_schema constrains to valid JSON (no schema-shape enforcement,
        # as in the JAX package)
        constraint = "json_object"
    g = req.grammar or {}
    if g.get("type") == "regex" and g.get("value"):
        constraint = "regex:" + str(g["value"])
    elif g.get("type") == "lark" and g.get("value"):
        constraint = "lark:" + str(g["value"])
    elif g.get("type") == "choice" and g.get("value"):
        constraint = _choice_constraint(tuple(str(c) for c in g["value"]))
    elif g.get("type") == "json_schema":
        constraint = "json_object"
    return constraint


def sampling_from_chat(req: P.ChatCompletionRequest) -> SamplingParams:
    stops = req.stop if isinstance(req.stop, list) else ([req.stop] if req.stop else [])
    bias = {}
    for k, v in (req.logit_bias or {}).items():
        try:
            bias[int(k)] = float(v)
        except ValueError:
            continue
    return SamplingParams(
        temperature=req.temperature if req.temperature is not None else 0.7,
        top_p=req.top_p if req.top_p is not None else 1.0,
        top_k=req.top_k or 0,
        min_p=req.min_p or 0.0,
        frequency_penalty=req.frequency_penalty or 0.0,
        presence_penalty=req.presence_penalty or 0.0,
        repetition_penalty=req.repetition_penalty or 1.0,
        max_tokens=req.max_tokens or req.max_completion_tokens or 512,
        seed=req.seed,
        logit_bias=bias,
        stop_strings=tuple(str(s) for s in stops),
        n_logprobs=(req.top_logprobs or 0) if req.logprobs else 0,
        constraint=_constraint_from_chat(req),
        dry_multiplier=req.dry_multiplier or 0.0,
        dry_base=req.dry_base if req.dry_base is not None else 1.75,
        dry_allowed_length=(req.dry_allowed_length
                            if req.dry_allowed_length is not None else 2),
        dry_sequence_breaker_ids=tuple(req.dry_sequence_breakers or ()),
    )


def _trim_stop_strings(text: str, stops) -> str:
    for s in stops or ():
        idx = text.find(s)
        if idx >= 0:
            text = text[:idx]
    return text


def _content_text(content, text_parts_only: bool = False) -> str:
    """A message's content as text: a string, or the ``text`` of a list's
    parts (of its ``"type": "text"`` parts alone, as the JAX ``/v1/messages``
    route reads a message; its system prompt and ``/v1/responses`` read every
    part)."""
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content if isinstance(p, dict)
                       and (not text_parts_only or p.get("type") == "text"))
    return content or ""


def _number(body: dict, key: str, default):
    v = body.get(key, default)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise ValueError(f"'{key}' has the wrong type: {v!r}")
    return v


class _HTTPError(Exception):
    """A route's error answer: HTTP ``status`` with the JSON ``body``."""

    def __init__(self, status: int, body: dict):
        super().__init__(status)
        self.status, self.body = status, body


def _error(status: int, message: str) -> _HTTPError:
    return _HTTPError(status, {"error": {"message": message}})


class _TokenStream:
    """Bridges engine-thread token callbacks to a request thread."""

    def __init__(self):
        self.queue: queue.Queue = queue.Queue()

    def on_tokens(self, toks: list[int], finished: bool) -> None:
        self.queue.put((list(toks), finished))

    def drain(self):
        while True:
            toks, fin = self.queue.get(timeout=TOKEN_TIMEOUT_S)
            yield toks, fin
            if fin:
                return


class _Handler(BaseHTTPRequestHandler):
    server_version = "mistralrs_tpu_torch"
    server: "_HTTPServer"

    def log_message(self, fmt, *args):  # quiet: one line per request is noise
        pass

    def send_response(self, code, message=None):
        self._status = code
        super().send_response(code, message)

    def _json(self, status: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _text(self, status: int, text: str) -> None:
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def _dispatch(self, method: str) -> None:
        """Route a request and count it in the server's metrics (method,
        path, status, seconds)."""
        owner: Server = self.server.owner
        path = urlsplit(self.path).path
        self._status = 500
        owner.metrics.begin()
        t0 = time.monotonic()
        try:
            route = _ROUTES.get((method, path))
            if route is None and path.startswith("/v1/responses/") and method in ("GET",
                                                                                   "DELETE"):
                route = _Handler._response_get if method == "GET" else _Handler._response_delete
            if route is None:
                raise _error(404, f"no route {method} {path}")
            route(self)
        except _HTTPError as e:
            self._json(e.status, e.body)
        finally:
            owner.metrics.observe(method, path, self._status, time.monotonic() - t0)

    # -- helpers ---------------------------------------------------------------

    def _body(self, status: int = 422):
        try:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"null")
        except (ValueError, json.JSONDecodeError) as e:
            raise _error(status, f"bad JSON body: {e}") from None

    def _object(self, status: int = 422) -> dict:
        body = self._body(status)
        if not isinstance(body, dict):
            raise _error(status, "request body must be a JSON object")
        return body

    def _instance(self, model_id) -> ModelInstance:
        inst = self.server.owner.resolve(model_id)
        if inst is None:
            raise _error(404, f"model {model_id!r} not found")
        return inst

    def _submit(self, inst: ModelInstance, prompt_ids, params: SamplingParams):
        stream = _TokenStream()
        try:
            seq = inst.submit(prompt_ids, params, stream.on_tokens)
        except (ValueError, NotImplementedError) as e:
            raise _error(400, str(e)) from None
        return seq, stream

    def _generate(self, inst: ModelInstance, prompt_ids, params: SamplingParams):
        """Run a request to its end; an engine error answers 500."""
        seq, stream = self._submit(inst, prompt_ids, params)
        for _toks, _fin in stream.drain():
            pass
        if seq.stop_reason == StopReason.ERROR:
            raise _error(500, "engine error")
        return seq

    @staticmethod
    def _usage(prompt_ids, seq) -> dict:
        n = len(seq.generated_ids)
        return {"prompt_tokens": len(prompt_ids), "completion_tokens": n,
                "total_tokens": len(prompt_ids) + n}

    # -- GET routes ------------------------------------------------------------

    def _health(self):
        self._json(200, {"status": "ok"})

    def _models(self):
        owner = self.server.owner
        self._json(200, {
            "object": "list",
            "data": [
                {"id": inst.model_id, "object": "model", "created": owner.created,
                 "owned_by": "mistralrs_tpu_torch",
                 "default": inst.model_id == owner.registry.default_id}
                for inst in owner.registry.list()
            ],
        })

    def _system_info(self):
        insts = self.server.owner.registry.list()
        devices = sorted({str(i.engine.device) for i in insts})
        dev = insts[0].engine.device if insts else None
        backend = (torch.cuda.get_device_name(dev) if dev is not None and dev.type == "cuda"
                   else "cpu")
        self._json(200, {"backend": backend, "devices": devices,
                         "platform": platform.platform(),
                         "models": [i.model_id for i in insts]})

    def _metrics(self):
        owner = self.server.owner
        inst = owner.registry.get()
        self._text(200, owner.metrics.render(inst.engine.stats if inst else {}))

    def _response_get(self):
        rid = urlsplit(self.path).path[len("/v1/responses/"):]
        with self.server.owner.responses_lock:
            resp = self.server.owner.responses.get(rid)
        if resp is None:
            raise _error(404, "response not found")
        self._json(200, resp)

    def _response_delete(self):
        rid = urlsplit(self.path).path[len("/v1/responses/"):]
        with self.server.owner.responses_lock:
            gone = self.server.owner.responses.pop(rid, None)
        if gone is None:
            raise _error(404, "response not found")
        self._json(200, {"id": rid, "deleted": True})

    # -- POST routes -----------------------------------------------------------

    def _chat(self):
        try:
            req = P.ChatCompletionRequest.parse(self._body())
        except NotImplementedError as e:
            raise _error(400, str(e)) from None
        except ValueError as e:
            raise _error(422, str(e)) from None
        inst = self._instance(req.model)
        try:
            msgs = [{"role": m.role, "content": m.text_content()} for m in req.messages]
        except ValueError as e:
            raise _error(400, str(e)) from None
        prompt = inst.chat_template.render(msgs, add_generation_prompt=True, tools=req.tools)
        prompt_ids = inst.tokenizer.encode(prompt)
        params = sampling_from_chat(req)
        if req.stream:
            seq, stream = self._submit(inst, prompt_ids, params)
            return self._stream_chat(inst, seq, stream, params)
        seq = self._generate(inst, prompt_ids, params)
        text = _trim_stop_strings(inst.tokenizer.decode(seq.generated_ids),
                                  params.stop_strings)
        reasoning, content = split_reasoning(text)
        finish = _FINISH_MAP.get(seq.stop_reason, "stop")
        logprobs_out = None
        if req.logprobs and seq.output_top_logprobs:
            dec = inst.tokenizer.decode
            logprobs_out = {"content": [
                {"token": dec([t]), "logprob": lp,
                 "top_logprobs": [{"token": dec([i]), "logprob": v} for i, v in tops.items()]}
                for t, lp, tops in zip(seq.generated_ids, seq.output_logprobs,
                                       seq.output_top_logprobs)
            ]}
        tool_calls = None
        if req.tools and (req.tool_choice or "auto") != "none":
            arch = inst.engine.cfg.arch
            matcher = ToolCallingMatcher(family=arch if arch in _TOOL_FAMILIES else "auto")
            calls = matcher.get_calls(content)
            if calls:
                tool_calls = [c.to_openai() for c in calls]
                finish = "tool_calls"
                content = ""
        resp = P.chat_completion_response(inst.model_id, content, finish,
                                          self._usage(prompt_ids, seq), logprobs=logprobs_out)
        message = resp["choices"][0]["message"]
        if reasoning:
            message["reasoning_content"] = reasoning
        if tool_calls:
            message["tool_calls"] = tool_calls
            message["content"] = None
        self._json(200, resp)

    def _completions(self):
        try:
            req = P.CompletionRequest.parse(self._body())
        except ValueError as e:
            raise _error(422, str(e)) from None
        inst = self._instance(req.model)
        if isinstance(req.prompt, list) and req.prompt and isinstance(req.prompt[0], int):
            prompt_ids, prompt_text = list(req.prompt), ""
        else:
            prompt_text = req.prompt if isinstance(req.prompt, str) else (
                req.prompt[0] if req.prompt else "")
            prompt_ids = inst.tokenizer.encode(prompt_text)
        stops = req.stop if isinstance(req.stop, list) else ([req.stop] if req.stop else [])
        params = SamplingParams(
            temperature=req.temperature if req.temperature is not None else 1.0,
            top_p=req.top_p if req.top_p is not None else 1.0,
            top_k=req.top_k or 0,
            frequency_penalty=req.frequency_penalty or 0.0,
            presence_penalty=req.presence_penalty or 0.0,
            max_tokens=req.max_tokens or 16,
            seed=req.seed,
            stop_strings=tuple(str(s) for s in stops),
        )
        seq = self._generate(inst, prompt_ids, params)
        text = _trim_stop_strings(inst.tokenizer.decode(seq.generated_ids),
                                  params.stop_strings)
        if req.echo:
            text = prompt_text + text
        self._json(200, P.completion_response(
            inst.model_id, text, _FINISH_MAP.get(seq.stop_reason, "stop"),
            self._usage(prompt_ids, seq)))

    def _messages(self):
        try:
            req = P.AnthropicMessagesRequest.parse(self._body())
        except ValueError as e:
            raise _HTTPError(422, {"type": "error", "error": {
                "type": "invalid_request_error", "message": str(e)}}) from None
        inst = self._instance(req.model)
        msgs = []
        if req.system:
            msgs.append({"role": "system", "content": _content_text(req.system)})
        for m in req.messages:
            msgs.append({"role": m["role"],
                         "content": _content_text(m.get("content"), text_parts_only=True)})
        prompt_ids = inst.tokenizer.encode(
            inst.chat_template.render(msgs, add_generation_prompt=True))
        params = SamplingParams(
            temperature=req.temperature if req.temperature is not None else 1.0,
            top_p=req.top_p if req.top_p is not None else 1.0,
            top_k=req.top_k or 0,
            max_tokens=req.max_tokens,
            stop_strings=tuple(req.stop_sequences or ()),
        )
        seq = self._generate(inst, prompt_ids, params)
        text = _trim_stop_strings(inst.tokenizer.decode(seq.generated_ids),
                                  params.stop_strings)
        usage = {"input_tokens": len(prompt_ids), "output_tokens": len(seq.generated_ids)}
        self._json(200, P.anthropic_response(
            inst.model_id, text, _ANTHROPIC_STOP.get(seq.stop_reason, "end_turn"), usage))

    def _count_tokens(self):
        body = self._object()
        inst = self._instance(body.get("model"))
        msgs = body.get("messages", [])
        if not isinstance(msgs, list) or not all(
                isinstance(m, dict) and isinstance(m.get("role"), str) for m in msgs):
            raise _error(422, "'messages' must be a list of objects with a 'role'")
        msgs = [{"role": m["role"], "content": m.get("content") or ""} for m in msgs]
        prompt = inst.chat_template.render(msgs, add_generation_prompt=True)
        self._json(200, {"input_tokens": len(inst.tokenizer.encode(prompt))})

    def _embeddings(self):
        body = self._object()
        inst = self._instance(body.get("model"))
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list):
            raise _error(422, "input must be string or list")
        if inputs and isinstance(inputs[0], int):
            batches = [list(inputs)]
        elif inputs and isinstance(inputs[0], list):
            batches = [list(x) for x in inputs]
        else:
            batches = [inst.tokenizer.encode(str(t)) for t in inputs]
        try:
            vecs = inst.embed(batches, pooling=body.get("pooling", "last"))
        except (ValueError, NotImplementedError) as e:
            raise _error(400, str(e)) from None
        n_tok = sum(len(b) for b in batches)
        self._json(200, {
            "object": "list",
            "data": [{"object": "embedding", "index": i, "embedding": v.tolist()}
                     for i, v in enumerate(vecs)],
            "model": inst.model_id,
            "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok},
        })

    def _responses(self):
        body = self._object()
        inst = self._instance(body.get("model"))
        inp = body.get("input", "")
        if isinstance(inp, str):
            msgs = [{"role": "user", "content": inp}]
        elif isinstance(inp, list) and all(isinstance(m, dict) for m in inp):
            msgs = [{"role": m.get("role", "user"),
                     "content": _content_text(m.get("content", ""))} for m in inp]
        else:
            raise _error(422, "'input' must be a string or a list of messages")
        if body.get("instructions"):
            msgs = [{"role": "system", "content": str(body["instructions"])}] + msgs
        prompt_ids = inst.tokenizer.encode(
            inst.chat_template.render(msgs, add_generation_prompt=True))
        try:
            params = SamplingParams(temperature=_number(body, "temperature", 1.0),
                                    top_p=_number(body, "top_p", 1.0),
                                    max_tokens=int(_number(body, "max_output_tokens", 512)))
        except ValueError as e:
            raise _error(422, str(e)) from None
        seq = self._generate(inst, prompt_ids, params)
        text = inst.tokenizer.decode(seq.generated_ids)
        rid = P.gen_id("resp")
        n_out = len(seq.generated_ids)
        resp = {
            "id": rid,
            "object": "response",
            "created_at": P.now(),
            "model": inst.model_id,
            "status": "completed",
            "output": [{"type": "message", "id": P.gen_id("msg"), "role": "assistant",
                        "content": [{"type": "output_text", "text": text}]}],
            "usage": {"input_tokens": len(prompt_ids), "output_tokens": n_out,
                      "total_tokens": len(prompt_ids) + n_out},
        }
        if body.get("store", True):
            owner = self.server.owner
            with owner.responses_lock:
                owner.responses[rid] = resp
        self._json(200, resp)

    def _models_load(self):
        body = self._object()
        model_id = body.get("model_id") or body.get("model")
        path = body.get("path")
        if not model_id or not path:
            raise _error(422, "model_id and path required")
        try:
            self.server.owner.registry.load(
                str(model_id), str(path), default=bool(body.get("default", False)),
                isq=body.get("isq"), engine_options=body.get("engine_options"))
        except Exception as e:  # noqa: BLE001 — the load's error is the answer
            raise _error(400, str(e)) from None
        self._json(200, {"status": "loaded", "model_id": model_id})

    def _models_unload(self):
        body = self._object()
        if not self.server.owner.registry.unload(body.get("model_id") or body.get("model")
                                                 or ""):
            raise _error(404, "model not found")
        self._json(200, {"status": "unloaded"})

    def _models_reload(self):
        body = self._object()
        try:
            ok = self.server.owner.registry.reload(body.get("model_id") or "")
        except Exception as e:  # noqa: BLE001 — the load's error is the answer
            raise _error(400, str(e)) from None
        if not ok:
            raise _error(404, "model not found or not reloadable")
        self._json(200, {"status": "reloaded"})

    def _stream_chat(self, inst, seq, stream: _TokenStream, params: SamplingParams):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        rid = P.gen_id("chatcmpl")
        detok = inst.tokenizer.detokenizer()
        first = True
        # stop-string holdback: never emit text that may start a stop string
        stops = list(params.stop_strings or ())
        holdback = max((len(s) for s in stops), default=1) - 1
        pending = ""
        stopped = False

        def write_delta(text, force=False):
            nonlocal first
            if text or (first and force):
                delta = {"content": text}
                if first:
                    delta["role"] = "assistant"
                    first = False
                chunk = P.chat_chunk(inst.model_id, rid, delta)
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()

        for toks, fin in stream.drain():
            delta_text = detok.push(toks) if toks else ""
            if fin:
                delta_text += detok.flush()
            if not stopped:
                pending += delta_text
                cut = min((i for i in (pending.find(s) for s in stops) if i >= 0), default=-1)
                if cut >= 0:
                    write_delta(pending[:cut], force=True)
                    pending = ""
                    stopped = True
                elif fin:
                    write_delta(pending, force=True)
                    pending = ""
                elif holdback and len(pending) > holdback:
                    write_delta(pending[:-holdback])
                    pending = pending[-holdback:]
                elif not holdback:
                    write_delta(pending)
                    pending = ""
            if fin:
                if first:
                    write_delta("", force=True)
                final = P.chat_chunk(inst.model_id, rid, {},
                                     _FINISH_MAP.get(seq.stop_reason, "stop"))
                self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()


_ROUTES = {
    ("GET", "/health"): _Handler._health,
    ("GET", "/v1/models"): _Handler._models,
    ("GET", "/v1/system/info"): _Handler._system_info,
    ("GET", "/metrics"): _Handler._metrics,
    ("POST", "/v1/chat/completions"): _Handler._chat,
    ("POST", "/v1/completions"): _Handler._completions,
    ("POST", "/v1/messages"): _Handler._messages,
    ("POST", "/v1/messages/count_tokens"): _Handler._count_tokens,
    ("POST", "/v1/embeddings"): _Handler._embeddings,
    ("POST", "/v1/responses"): _Handler._responses,
    ("POST", "/v1/models/load"): _Handler._models_load,
    ("POST", "/v1/models/unload"): _Handler._models_unload,
    ("POST", "/v1/models/reload"): _Handler._models_reload,
}


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    owner: "Server"


class Server:
    """The HTTP front end over a model registry."""

    def __init__(
        self,
        engine: Engine,
        tokenizer,
        chat_template: ChatTemplate,
        model_id: str = "default",
        *,
        host: str = "127.0.0.1",
        port: int = 8080,
    ):
        self.registry = ModelRegistry()
        self.metrics = Metrics()
        self.responses: dict[str, dict] = {}  # /v1/responses kept for GET and DELETE
        self.responses_lock = threading.Lock()
        self.created = int(time.time())
        self.registry.register(
            ModelInstance(model_id=model_id, engine=engine, tokenizer=tokenizer,
                          chat_template=chat_template),
            default=True,
        )
        self.httpd = _HTTPServer((host, port), _Handler)
        self.httpd.owner = self
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return host, port

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def resolve(self, model_id: Optional[str]) -> Optional[ModelInstance]:
        """Exact id, None/"default" → the default model; a single-model server
        maps any name to its model (clients send placeholder names)."""
        inst = self.registry.get(model_id)
        if inst is None and model_id:
            insts = self.registry.list()
            if len(insts) == 1:
                return insts[0]
        return inst

    def start(self) -> None:
        """Serve from a background thread."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        """Serve on the calling thread until interrupted, then shut down."""
        try:
            self.httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the HTTP loop, close the socket, join the server and engine
        threads."""
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("HTTP server thread did not stop")
            self._thread = None
        self.httpd.server_close()
        self.registry.shutdown()
