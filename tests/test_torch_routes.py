"""The engine's constrained decoding and DRY and the server's text routes in
the port, against the JAX package on the CPU.

* One JAX ``Engine`` case: regex-, JSON- and choice-constrained greedy
  requests and a DRY one in one batch on a 2-layer llama (f32) give the
  JAX engine's tokens and stop reasons (its JSON recognizer with
  ``_DIGITS`` patched back to bytes; test_torch_grammar.py).
* A slot's constraint-bias row is cleared when the next request takes the
  slot; a recomputed (preempted) request resumes its recognizer where its
  output left it, where the JAX engine starts it again (ROADMAP Queue 3).
* Each route's JSON has the keys and value types of the JAX helpers'
  (``mistralrs_tpu/serving/protocol.py``) or of the JAX route's literal
  dictionary, through the port's server on port 0; the request types parse
  as the JAX pydantic models do and refuse what they refuse (the port
  does not coerce a numeric string to a number, as pydantic's lax mode
  does, and refuses an Anthropic message without a role, where the JAX
  route fails on it); tool calls and reasoning text come back as the JAX
  chat route returns them (the model forced to emit them by a choice
  grammar).
* ``parse_tool_calls``, ``split_reasoning`` and ``ReasoningParser`` equal
  the JAX ones on the strings of tests/test_tools.py.
* A tiny Q4_K GGUF written into ``tmp_path`` is loaded, served, reloaded
  and unloaded through the routes; unknown models answer 404.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mistralrs_tpu.grammar as jax_grammar
from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.models import ModelConfig as JaxConfig
from mistralrs_tpu.models import init_random_weights as jax_init
from mistralrs_tpu.serving import protocol as JP
from mistralrs_tpu.tools import ReasoningParser as JaxReasoningParser
from mistralrs_tpu.tools import parse_tool_calls as jax_parse_tool_calls
from mistralrs_tpu.tools import split_reasoning as jax_split_reasoning
from mistralrs_tpu_torch.chat_template import resolve_chat_template
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.sequence import StopReason
from mistralrs_tpu_torch.grammar import ChoiceConstraint, RegexConstraint
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.serving import protocol as P
from mistralrs_tpu_torch.serving.server import Server
from mistralrs_tpu_torch.tokenizer import Detokenizer
from mistralrs_tpu_torch.tools import ReasoningParser, parse_tool_calls, split_reasoning

from test_torch_cuda_routes import write_tiny_gguf

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: beside the suite's other workers, torch's
    intra-op threads make them crawl (as in test_torch_isq.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(arch="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=512, eos_token_ids=(0,))
JCFG, CFG = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
JW = jax_init(JCFG, seed=11, dtype=jnp.float32, scale=0.1)
TW = from_jax_params(
    {k: (None if v is None else
         {kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
         else np.asarray(v)) for k, v in JW.items()},
    CFG, device="cpu", dtype=torch.float32,
)
REGEX = r"[a-z]{2,6}( [a-z]{2,6}){2,4}\."
CHOICES = ["alpha", "alphabet", "beta"]


class ByteTokenizer:
    """UTF-8 bytes as token ids (both packages' tokenizer interface)."""

    def encode(self, text, add_bos=None):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def detokenizer(self):
        return Detokenizer(self)


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 256, length + 3 * i)] for i in range(n)]


def _port_engine(**kw):
    opts = dict(num_blocks=64, block_size=16, max_batch=4)
    opts.update(kw)
    return Engine(CFG, TW, compute_dtype=torch.float32, device="cpu", tokenizer=ByteTokenizer(),
                  **opts)


def test_constrained_and_dry_batch_matches_jax_engine(monkeypatch):
    monkeypatch.setattr(jax_grammar, "_DIGITS", b"0123456789")
    je = JaxEngine(JCFG, JW, num_blocks=64, block_size=16, max_batch=4, backend="xla",
                   compute_dtype=jnp.float32, tokenizer=ByteTokenizer())
    te = _port_engine()
    # the bias steers the JSON row through a key and a value to completion
    bias = {ord(c): v for c, v in zip('{":}', (3, 7, 5, 4))}
    kinds = [dict(constraint="regex:" + REGEX), dict(constraint="json_object", logit_bias=bias),
             dict(constraint="choice"), dict(dry_multiplier=1.5, dry_allowed_length=2)]
    out = {}
    for eng, Params, choice in ((je, JaxParams, jax_grammar.ChoiceConstraint),
                                (te, SamplingParams, ChoiceConstraint)):
        seqs = []
        for p, kw in zip(_prompts(4, 6, seed=5), kinds):
            kw = dict(kw)
            if kw.get("constraint") == "choice":
                kw["constraint"] = choice(CHOICES)
            seqs.append(eng.add_request(p, Params(temperature=0.0, max_tokens=24, **kw)))
        eng.run_to_completion()
        out[eng] = [(s.generated_ids, s.stop_reason.value) for s in seqs]
    assert out[te] == out[je]
    text = [bytes(ids).decode("utf-8", "replace") for ids, _ in out[te]]
    assert json.loads(text[1]) == {"": ""} and out[te][1][1] == "stop_token"
    assert text[2] in CHOICES and out[te][2][1] == "stop_token"
    assert out[te][0][1] != "stop_token" or RegexConstraint(REGEX).is_complete(
        _advance(RegexConstraint(REGEX), out[te][0][0]))
    assert te.stats["constraint_masks"] > 0


def _advance(cons, ids):
    st = cons.initial()
    for by in bytes(ids):
        st = cons.advance(st, by)
        if st is None:
            return None
    return st


def test_slot_reuse_clears_the_row():
    te = _port_engine(max_batch=1)
    p1, p2 = _prompts(2, 8, seed=6)
    a = te.add_request(p1, SamplingParams(temperature=0.0, max_tokens=12,
                                          constraint="regex:" + REGEX))
    te.run_to_completion()
    assert a.is_finished
    assert (te.samp_state.constraint_bias[0] != 0).any()  # the last mask stays until reuse
    b = te.add_request(p2, SamplingParams(temperature=0.0, max_tokens=10))
    te.run_to_completion()
    assert not te.samp_state.constraint_bias[0].any()
    fresh = _port_engine(max_batch=1)
    c = fresh.add_request(p2, SamplingParams(temperature=0.0, max_tokens=10))
    fresh.run_to_completion()
    assert b.generated_ids == c.generated_ids and len(b.generated_ids) == 10


def test_requests_with_one_constraint_share_its_recognizer():
    """One recognizer, so one transition table in the mask builder, for the
    requests that give the same constraint (recognizers hold no state of a
    request: each sequence keeps its own)."""
    from mistralrs_tpu_torch.serving.server import sampling_from_chat

    te = _port_engine(max_batch=2)
    seqs = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=6,
                                             constraint="regex:" + REGEX))
            for p in _prompts(2, 8, seed=7)]
    assert seqs[0].constraint is seqs[1].constraint
    te.run_to_completion()
    assert all(_advance(RegexConstraint(REGEX), s.generated_ids) is not None for s in seqs)
    body = {"messages": [{"role": "user", "content": "x"}],
            "grammar": {"type": "choice", "value": ["yes", "no"]}}
    a, b = (sampling_from_chat(P.ChatCompletionRequest.parse(body)).constraint for _ in "ab")
    assert a is b and isinstance(a, ChoiceConstraint)


def test_constraint_resumes_after_preemption():
    """A 9-block pool cannot hold three 60-token sequences: recompute
    preemption folds the output into the prompt, and the recognizer goes on
    from where the output left it (``a`` once, then never again)."""
    te = _port_engine(num_blocks=9)
    seqs = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=40,
                                             constraint=r"regex:a[b-z]{50,60}\."))
            for p in _prompts(3, 20, seed=2)]
    te.run_to_completion()
    assert te.stats["preemptions"] > 0
    for s in seqs:
        assert len(s.generated_ids) == 40 and s.stop_reason == StopReason.LENGTH
        assert _advance(RegexConstraint(r"a[b-z]{50,60}\."), s.generated_ids) is not None


# -- routes ------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    srv = Server(_port_engine(), ByteTokenizer(), resolve_chat_template(arch="llama"), "tiny",
                 host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.shutdown()


def _call(srv, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(srv.url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read().decode()
    try:
        return status, json.loads(raw)
    except json.JSONDecodeError:
        return status, raw


def _shape(obj):
    """Keys and value types of a JSON value (ints count as numbers)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj[:1]]
    if isinstance(obj, bool) or obj is None:
        return type(obj).__name__
    return "number" if isinstance(obj, (int, float)) else type(obj).__name__


USAGE = {"prompt_tokens": 3, "completion_tokens": 2, "total_tokens": 5}


def test_chat_and_completion_json_match_jax_helpers(server):
    status, chat = _call(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0,
        "response_format": {"type": "json_object"}, "dry_multiplier": 0.5})
    assert status == 200
    assert _shape(chat) == _shape(JP.chat_completion_response("m", "x", "stop", USAGE))
    status, cmpl = _call(server, "/v1/completions", {"prompt": "abc", "max_tokens": 3,
                                                     "n": 2, "stream": True})
    assert status == 200 and cmpl["usage"]["completion_tokens"] == 3
    assert _shape(cmpl) == _shape(JP.completion_response("m", "x", "length", USAGE))
    status, msg = _call(server, "/v1/messages", {
        "max_tokens": 3, "system": [{"type": "text", "text": "be brief"}],
        "messages": [{"role": "user", "content": [{"type": "text", "text": "hi"}]}]})
    assert status == 200 and msg["stop_reason"] == "max_tokens"
    assert _shape(msg) == _shape(JP.anthropic_response(
        "m", "x", "end_turn", {"input_tokens": 1, "output_tokens": 2}))
    status, err = _call(server, "/v1/messages", {"messages": "no"})
    assert status == 422 and err["type"] == "error"
    assert err["error"]["type"] == "invalid_request_error"


def test_tool_calls_and_reasoning_as_the_jax_route_returns_them(server):
    call = '{"name": "get_weather", "arguments": {"city": "Paris"}}'
    tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]
    status, body = _call(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather?"}], "tools": tools,
        "max_tokens": 80, "temperature": 0, "grammar": {"type": "choice", "value": [call]}})
    assert status == 200
    choice = body["choices"][0]
    assert choice["finish_reason"] == "tool_calls" and choice["message"]["content"] is None
    (tc,) = choice["message"]["tool_calls"]
    (want,) = jax_parse_tool_calls(call, "llama")
    assert _shape(tc) == _shape(want.to_openai())
    assert tc["function"] == want.to_openai()["function"]
    status, body = _call(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "think"}], "max_tokens": 80, "temperature": 0,
        "grammar": {"type": "choice", "value": ["<think>step one</think>\nthe answer"]}})
    message = body["choices"][0]["message"]
    assert (message["reasoning_content"], message["content"]) == jax_split_reasoning(
        "<think>step one</think>\nthe answer") == ("step one", "the answer")
    status, body = _call(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "grammar": {"type": "regex",
                                                                    "value": "(unclosed"}})
    assert status == 400


def test_other_routes_json(server):
    status, emb = _call(server, "/v1/embeddings", {"input": ["ab", "cde"], "pooling": "mean"})
    assert status == 200
    assert _shape(emb) == {"object": "str", "model": "str",
                           "data": [{"object": "str", "index": "number",
                                     "embedding": ["number"]}],
                           "usage": {"prompt_tokens": "number", "total_tokens": "number"}}
    assert len(emb["data"]) == 2 and len(emb["data"][0]["embedding"]) == CFG.hidden_size
    assert emb["usage"]["prompt_tokens"] == 5
    assert _call(server, "/v1/embeddings", {"input": 3})[0] == 422
    status, resp = _call(server, "/v1/responses", {"input": "hi", "max_output_tokens": 3,
                                                   "instructions": "be brief"})
    assert status == 200 and resp["object"] == "response" and resp["status"] == "completed"
    assert _shape(resp) == {
        "id": "str", "object": "str", "created_at": "number", "model": "str", "status": "str",
        "output": [{"type": "str", "id": "str", "role": "str",
                    "content": [{"type": "str", "text": "str"}]}],
        "usage": {"input_tokens": "number", "output_tokens": "number",
                  "total_tokens": "number"}}
    rid = resp["id"]
    assert _call(server, f"/v1/responses/{rid}") == (200, resp)
    assert _call(server, f"/v1/responses/{rid}", method="DELETE") == (
        200, {"id": rid, "deleted": True})
    assert _call(server, f"/v1/responses/{rid}")[0] == 404
    status, n = _call(server, "/v1/messages/count_tokens",
                      {"messages": [{"role": "user", "content": "count"}]})
    tmpl = resolve_chat_template(arch="llama")
    assert n == {"input_tokens": len(tmpl.render([{"role": "user", "content": "count"}]).encode())}
    status, info = _call(server, "/v1/system/info")
    assert status == 200 and info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert sorted(info) == ["backend", "devices", "models", "platform"]
    status, text = _call(server, "/metrics")
    assert status == 200
    assert 'http_requests_total{method="POST",route="/v1/embeddings",status="200"}' in text
    assert "http_requests_in_flight 1" in text and "engine_generated_tokens" in text


@pytest.mark.parametrize("body", [
    {"prompt": "x"}, {"prompt": ["a", "b"], "stop": ["\n"], "echo": True, "max_tokens": 4},
    {"prompt": [1, 2, 3], "temperature": 0.5, "top_k": 3, "n": 2, "seed": 9},
])
def test_completion_request_parses_as_jax(body):
    port = P.CompletionRequest.parse(body)
    jax_req = JP.CompletionRequest.model_validate(body)
    assert {k: getattr(port, k) for k in type(jax_req).model_fields} == jax_req.model_dump()


@pytest.mark.parametrize("body", [
    {"messages": [{"role": "user", "content": "hi"}]},
    {"messages": [{"role": "user", "content": [{"type": "text", "text": "x"}]}],
     "system": "s", "max_tokens": 7, "stop_sequences": ["END"], "top_k": 2},
])
def test_anthropic_request_parses_as_jax(body):
    port = P.AnthropicMessagesRequest.parse(body)
    jax_req = JP.AnthropicMessagesRequest.model_validate(body)
    assert {k: getattr(port, k) for k in type(jax_req).model_fields} == jax_req.model_dump()


@pytest.mark.parametrize("kind,body", [
    ("completion", {"prompt": 3}), ("completion", {}), ("completion", {"prompt": "x",
                                                                       "max_tokens": [4]}),
    ("anthropic", {"messages": ["no object"]}),
    ("anthropic", {"messages": [], "stop_sequences": "END"}),
    ("chat", {"messages": [{"role": "user"}], "tools": "x"}),
    ("chat", {"messages": [{"role": "user"}], "dry_sequence_breakers": ["a"]}),
])
def test_bad_request_bodies_refused_as_jax(kind, body):
    port, jax_model = {"completion": (P.CompletionRequest, JP.CompletionRequest),
                       "anthropic": (P.AnthropicMessagesRequest, JP.AnthropicMessagesRequest),
                       "chat": (P.ChatCompletionRequest, JP.ChatCompletionRequest)}[kind]
    with pytest.raises(ValueError):
        port.parse(body)
    with pytest.raises(ValueError):  # pydantic's ValidationError is a ValueError
        jax_model.model_validate(body)


def test_chat_request_fields_parse_as_jax():
    body = {"messages": [{"role": "user", "content": "x"}], "tools": [{"type": "function"}],
            "tool_choice": "auto", "response_format": {"type": "json_object"},
            "grammar": {"type": "regex", "value": "a+"}, "dry_multiplier": 0.8,
            "dry_base": 2, "dry_allowed_length": 3, "dry_sequence_breakers": [1, 2]}
    port = P.ChatCompletionRequest.parse(body)
    jax_req = JP.ChatCompletionRequest.model_validate(body)
    for k in ("tools", "tool_choice", "response_format", "grammar", "dry_multiplier",
              "dry_base", "dry_allowed_length", "dry_sequence_breakers"):
        assert getattr(port, k) == getattr(jax_req, k), k


# the strings of tests/test_tools.py
TOOL_TEXTS = [
    ('{"name": "get_weather", "parameters": {"city": "Paris"}}', "llama"),
    ('{"name": "a", "parameters": {}}; {"name": "b", "parameters": {"x": 1}}', "llama"),
    ('[TOOL_CALLS][{"name": "search", "arguments": {"q": "tpu"}}]', "mistral"),
    ("I'll check.\n<tool_call>\n" '{"name": "lookup", "arguments": {"id": 7}}\n'
     "</tool_call>", "qwen"),
    ('```json\n{"name": "calc", "arguments": {"e": "1+1"}}\n```', "gemma"),
    ("Just a normal sentence.", "auto"),
    ('The answer is {"x": 1}. Hope that helps', "auto"),
    ('<tool_call>{"name": "f", "arguments": {}}</tool_call>', "auto"),
    ('{"name": "f", "arguments": {"a": 2}}', "llama"),
    ('ok <tool_calls>[{"name": "get_weather", "arguments": '
     '{"city": "Paris"}}, {"name": "now", "arguments": {}}]</tool_calls>', "hunyuan"),
    ('<|tool_call_start|>[get_weather(location="Paris", days=3, '
     'metric=True)]<|tool_call_end|>', "lfm2"),
    ('<|tool_call>call:get_weather{location:<|"|>New York, NY<|"|>,'
     'days:3,wet:true}<tool_call|>', "gemma4"),
    ('<|channel|>commentary to=functions.get_weather '
     '<|constrain|>json<|message|>{"city": "Oslo"}<|call|>', "gpt_oss"),
]


@pytest.mark.parametrize("text,family", TOOL_TEXTS)
def test_parse_tool_calls_matches_jax(text, family):
    for fam in (family, "auto"):
        got = parse_tool_calls(text, fam)
        want = jax_parse_tool_calls(text, fam)
        assert [(c.name, c.arguments) for c in got] == [(c.name, c.arguments) for c in want]
        for c, w in zip(got, want):
            assert _shape(c.to_openai()) == _shape(w.to_openai())
            assert c.to_openai()["function"] == w.to_openai()["function"]


@pytest.mark.parametrize("text", [
    "<think>step 1\nstep 2</think>\nAnswer: 42", "no tags here", "<think>endless thought",
    "implicit thought</think>final", "<thinking>a</thinking>b",
])
def test_split_reasoning_matches_jax(text):
    assert split_reasoning(text) == jax_split_reasoning(text)


@pytest.mark.parametrize("deltas", [["<thi", "nk>rea", "soning</th", "ink>ans", "wer"],
                                    ["hello ", "world"]])
def test_reasoning_parser_matches_jax(deltas):
    port, jax_p = ReasoningParser(), JaxReasoningParser()
    assert [port.push(d) for d in deltas] == [jax_p.push(d) for d in deltas]
    assert port.flush() == jax_p.flush()


def test_load_serve_reload_unload_routes(server, tmp_path):
    path = tmp_path / "tiny.gguf"
    write_tiny_gguf(path, seed=3, hidden=256, inter=512)
    opts = {"num_blocks": 32, "block_size": 16, "max_batch": 2, "max_model_len": 256}
    assert _call(server, "/v1/models/load", {"model_id": "gguf"})[0] == 422
    status, err = _call(server, "/v1/models/load", {"model_id": "x", "path": str(tmp_path / "no")})
    assert status == 400 and "not a .gguf/.uqff file or a directory" in err["error"]["message"]
    status, body = _call(server, "/v1/models/load", {"model_id": "gguf", "path": str(path),
                                                     "engine_options": opts})
    assert (status, body) == (200, {"status": "loaded", "model_id": "gguf"})
    assert [m["id"] for m in _call(server, "/v1/models")[1]["data"]] == ["tiny", "gguf"]
    req = {"model": "gguf", "messages": [{"role": "user", "content": "hello"}],
           "max_tokens": 5, "temperature": 0, "stop": ["\u0000never"]}
    status, first = _call(server, "/v1/chat/completions", req)
    assert status == 200 and first["model"] == "gguf"
    assert first["usage"]["completion_tokens"] <= 5
    # the loaded engine has the model's tokenizer (ROADMAP Queue 3 item 18)
    status, body = _call(server, "/v1/chat/completions", dict(
        req, max_tokens=20, grammar={"type": "choice", "value": ["yes", "no"]}))
    assert status == 200 and body["choices"][0]["message"]["content"] in ("yes", "no")
    assert _call(server, "/v1/chat/completions", dict(req, model="nope"))[0] == 404
    assert _call(server, "/v1/models/reload", {"model_id": "gguf"}) == (
        200, {"status": "reloaded"})
    assert _call(server, "/v1/chat/completions", req)[1]["choices"] == first["choices"]
    assert _call(server, "/v1/models/reload", {"model_id": "tiny"})[0] == 404  # no source
    assert _call(server, "/v1/models/unload", {"model_id": "gguf"}) == (
        200, {"status": "unloaded"})
    assert _call(server, "/v1/models/unload", {"model_id": "gguf"})[0] == 404
    assert [m["id"] for m in _call(server, "/v1/models")[1]["data"]] == ["tiny"]


def test_load_builds_only_the_engine_under_the_device_lock(server, tmp_path, monkeypatch):
    """The models served on a device step on while another is read from
    disk and placed; only its engine is built under the device's lock."""
    import threading

    from mistralrs_tpu_torch import pipeline
    from mistralrs_tpu_torch.ops._cuda import device_lock
    from mistralrs_tpu_torch.serving import registry as registry_mod

    def lock_free_elsewhere():
        got = []

        def probe():
            lock = device_lock(torch.device("cpu"))
            got.append(lock.acquire(blocking=False))
            if got[0]:
                lock.release()

        t = threading.Thread(target=probe)
        t.start()
        t.join()
        return got[0]

    seen = {}
    real_load, real_engine = pipeline.load_pipeline, registry_mod.Engine

    def load(*a, **kw):
        seen["read"] = lock_free_elsewhere()
        return real_load(*a, **kw)

    def engine(*a, **kw):
        seen["engine"] = lock_free_elsewhere()
        return real_engine(*a, **kw)

    monkeypatch.setattr(pipeline, "load_pipeline", load)
    monkeypatch.setattr(registry_mod, "Engine", engine)
    path = tmp_path / "tiny.gguf"
    write_tiny_gguf(path, seed=4, hidden=256, inter=512)
    reg = server.registry
    inst = reg.load("locked", str(path), engine_options={"num_blocks": 16, "block_size": 16,
                                                         "max_batch": 1, "max_model_len": 64})
    assert inst.engine.device == torch.device("cpu")
    assert seen == {"read": True, "engine": False}
    assert reg.unload("locked")


def test_unload_ends_requests_in_flight(server):
    """ROADMAP Queue 3 item 19: a request decoding when its model is
    unloaded ends (ERROR, its final event delivered) instead of waiting."""
    import threading

    from mistralrs_tpu_torch.engine.engine import Engine as PortEngine
    from mistralrs_tpu_torch.serving.registry import ModelInstance, ModelRegistry

    reg = ModelRegistry()
    eng = PortEngine(CFG, TW, num_blocks=64, block_size=16, max_batch=2, device="cpu",
                     compute_dtype=torch.float32)
    reg.register(ModelInstance("m", eng, ByteTokenizer(), resolve_chat_template(arch="llama")))
    started, ended = threading.Event(), threading.Event()

    def on_tokens(toks, fin):
        started.set()
        if fin:
            ended.set()

    seq = reg.get("m").submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=480),
                              on_tokens)
    assert started.wait(60)
    assert reg.unload("m")
    assert ended.wait(10) and seq.stop_reason == StopReason.ERROR
    assert len(seq.generated_ids) < 480 and reg.get("m") is None
