"""OpenAI-compatible HTTP server on the standard library (counterpart of
``mistralrs_tpu/serving/server.py``, which is built on aiohttp).

Routes: ``GET /health``, ``GET /v1/models`` and ``POST /v1/chat/completions``
(blocking, or Server-Sent Events with ``"stream": true``), with the JSON of
the JAX server's routes. ``http.server.ThreadingHTTPServer`` handles each
connection on its own thread; the registry's engine thread steps the engine
and hands tokens to the request threads through queues.

``Server.start()`` serves from a background thread (tests, the card's smoke
run); ``Server.shutdown()`` stops the HTTP loop, closes the socket and joins
the server and engine threads.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..chat_template import ChatTemplate
from ..engine.engine import Engine
from ..engine.sampler import SamplingParams
from ..engine.sequence import StopReason
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

#: longest a request thread waits for the engine between two token batches
TOKEN_TIMEOUT_S = 600.0


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
    )


def _trim_stop_strings(text: str, stops) -> str:
    for s in stops or ():
        idx = text.find(s)
        if idx >= 0:
            text = text[:idx]
    return text


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

    def _json(self, status: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str) -> None:
        self._json(status, {"error": {"message": message}})

    def do_GET(self):
        owner = self.server.owner
        if self.path == "/health":
            return self._json(200, {"status": "ok"})
        if self.path == "/v1/models":
            return self._json(200, {
                "object": "list",
                "data": [
                    {"id": inst.model_id, "object": "model", "created": owner.created,
                     "owned_by": "mistralrs_tpu_torch",
                     "default": inst.model_id == owner.registry.default_id}
                    for inst in owner.registry.list()
                ],
            })
        return self._error(404, f"no route {self.path}")

    def do_POST(self):
        if self.path != "/v1/chat/completions":
            return self._error(404, f"no route {self.path}")
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = P.ChatCompletionRequest.parse(json.loads(self.rfile.read(n) or b"null"))
        except NotImplementedError as e:
            return self._error(400, str(e))
        except (ValueError, json.JSONDecodeError) as e:
            return self._error(422, str(e))
        owner = self.server.owner
        inst = owner.resolve(req.model)
        if inst is None:
            return self._error(404, f"model {req.model!r} not found")
        try:
            msgs = [{"role": m.role, "content": m.text_content()} for m in req.messages]
        except ValueError as e:
            return self._error(400, str(e))
        prompt = inst.chat_template.render(msgs, add_generation_prompt=True)
        prompt_ids = inst.tokenizer.encode(prompt)
        params = sampling_from_chat(req)
        stream = _TokenStream()
        try:
            seq = inst.submit(prompt_ids, params, stream.on_tokens)
        except (ValueError, NotImplementedError) as e:
            return self._error(400, str(e))
        if req.stream:
            return self._stream_chat(inst, seq, stream, params)
        for _toks, _fin in stream.drain():
            pass
        if seq.stop_reason == StopReason.ERROR:
            return self._error(500, "engine error")
        text = _trim_stop_strings(inst.tokenizer.decode(seq.generated_ids),
                                  params.stop_strings)
        usage = {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(seq.generated_ids),
            "total_tokens": len(prompt_ids) + len(seq.generated_ids),
        }
        logprobs_out = None
        if req.logprobs and seq.output_top_logprobs:
            dec = inst.tokenizer.decode
            logprobs_out = {"content": [
                {"token": dec([t]), "logprob": lp,
                 "top_logprobs": [{"token": dec([i]), "logprob": v} for i, v in tops.items()]}
                for t, lp, tops in zip(seq.generated_ids, seq.output_logprobs,
                                       seq.output_top_logprobs)
            ]}
        finish = _FINISH_MAP.get(seq.stop_reason, "stop")
        return self._json(200, P.chat_completion_response(
            inst.model_id, text, finish, usage, logprobs=logprobs_out))

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
