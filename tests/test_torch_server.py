"""The port's standard-library server on port 0: /health, /v1/models, and
blocking and SSE chat completions over a tiny random model on the CPU, then
``shutdown()`` joins the server and engine threads."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from mistralrs_tpu_torch.chat_template import resolve_chat_template
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.models import ModelConfig, init_random_weights
from mistralrs_tpu_torch.serving.server import Server
from mistralrs_tpu_torch.tokenizer import Detokenizer

CFG = ModelConfig(
    arch="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=512,
)


class ByteTokenizer:
    """UTF-8 bytes as token ids (the port's tokenizer interface, without
    the ``tokenizers`` package)."""

    def encode(self, text, add_bos=None):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def detokenizer(self):
        return Detokenizer(self)


@pytest.fixture(scope="module")
def server():
    eng = Engine(CFG, init_random_weights(CFG, seed=3, device="cpu"), num_blocks=64, block_size=16,
                 max_batch=4, prefill_chunk=32, device="cpu")
    srv = Server(eng, ByteTokenizer(), resolve_chat_template(arch="llama"), "tiny",
                 host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.shutdown()


def _get(srv, path):
    with urllib.request.urlopen(srv.url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(srv, body):
    req = urllib.request.Request(srv.url + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_health_and_models(server):
    assert _get(server, "/health") == (200, {"status": "ok"})
    status, body = _get(server, "/v1/models")
    assert status == 200 and body["object"] == "list"
    assert [m["id"] for m in body["data"]] == ["tiny"] and body["data"][0]["default"]


def test_blocking_chat(server):
    with _post(server, {"messages": [{"role": "user", "content": "hello there"}],
                        "max_tokens": 6, "temperature": 0}) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["finish_reason"] == "length" and choice["message"]["role"] == "assistant"
    usage = body["usage"]
    assert usage["completion_tokens"] == 6
    assert usage["total_tokens"] == usage["prompt_tokens"] + 6 and usage["prompt_tokens"] > 11


def test_concurrent_blocking_and_seeded(server):
    """Four concurrent requests (two seeded identically) all finish; the
    seeded pair returns identical text."""
    results = [None] * 4

    def go(i):
        body = {"messages": [{"role": "user", "content": "abc " * (i + 1)}],
                "max_tokens": 5, "temperature": 0.8, "seed": 5}
        if i >= 2:
            body["messages"][0]["content"] = "same prompt"
        with _post(server, body) as r:
            results[i] = json.loads(r.read())

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert all(r["usage"]["completion_tokens"] == 5 for r in results)
    assert results[2]["choices"][0]["message"] == results[3]["choices"][0]["message"]


def test_streaming_chat(server):
    with _post(server, {"messages": [{"role": "user", "content": "stream please"}],
                        "max_tokens": 7, "temperature": 0, "stream": True}) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/event-stream"
        raw = r.read().decode()
    events = [line[len("data: "):] for line in raw.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_bad_requests(server):
    for body, status in (({"messages": []}, 422),
                         ({"messages": [{"role": "user", "content": "x"}],
                           "adapters": ["a"]}, 400),
                         ({"messages": [{"role": "user", "content": "x"}], "n": 2}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body)
        assert e.value.code == status
        assert "message" in json.loads(e.value.read())["error"]


def test_shutdown_joins_threads():
    eng = Engine(CFG, init_random_weights(CFG, seed=4, device="cpu"), num_blocks=16, block_size=16,
                 max_batch=2, device="cpu")
    srv = Server(eng, ByteTokenizer(), resolve_chat_template(arch="llama"),
                 host="127.0.0.1", port=0)
    before = set(threading.enumerate())
    srv.start()
    with _post(srv, {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
                     "temperature": 0}) as r:
        assert r.status == 200
    srv.shutdown()
    for t in threading.enumerate():  # a handler thread may still be closing
        if t not in before:
            t.join(10)
    leftover = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert leftover == [], leftover
