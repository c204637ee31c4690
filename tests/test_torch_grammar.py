"""The port's grammar constraints (``mistralrs_tpu_torch.grammar``,
``cfg_grammar``) and DRY row against the JAX package's, on the same seeded
inputs.

A vocabulary of 600 tokens drawn from a seed (JSON punctuation, digits,
letters, whitespace, escapes and multi-byte UTF-8 characters, 1-6
characters each, the first 128 single ASCII characters, a few empty
tokens) serves both packages' ``TokenMaskBuilder``. At every state along
seeded strings of each kind (JSON documents, strings of four regexes,
choices with shared prefixes, sentences of a Lark grammar) the allow-masks
must be equal bit for bit, EOS included only where the state is complete,
and ``advance_with_token`` must take both recognizers to states whose masks
again agree (or kill both).

The JAX JSON recognizer takes no digit outside a string: its module binds
``_DIGITS`` to the JSON digits as bytes and then rebinds the name to the
regex's frozenset of ints, so ``b"1" in _DIGITS`` is false (ROADMAP Queue
3). The JSON comparisons run it with that name patched back to the bytes
(its evident intent); ``test_jax_json_refuses_digits`` pins the fault.
"""

import json

import numpy as np
import pytest

import mistralrs_tpu.grammar as jax_grammar
from mistralrs_tpu.cfg_grammar import LarkConstraint as JaxLark
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.engine.sampler import dry_penalty_row as jax_dry
from mistralrs_tpu_torch import grammar
from mistralrs_tpu_torch.cfg_grammar import LarkConstraint
from mistralrs_tpu_torch.engine.sampler import SamplingParams, dry_penalty_row

V = 600
EOS = (200, 321)  # two of the empty tokens: allowed exactly where the state is complete
ALPHABET = (list('{}[]":,.-+eE0123456789 \n\tabcdefnrtulsxyz\\/')
            + ["é", "ü", "日本", "€", "ß"])


class TableTokenizer:
    """Token ids → fixed strings (the tokenizer interface both packages'
    mask builders read)."""

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.table = [chr(i) for i in range(128)]
        while len(self.table) < V:
            n = int(rng.integers(1, 7))
            self.table.append("".join(rng.choice(ALPHABET, n)))
        for i in (200, 321, 450):
            self.table[i] = ""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(self.table[i] for i in ids)


TOK = TableTokenizer()
PORT = grammar.TokenMaskBuilder(TOK, V)
JAX = jax_grammar.TokenMaskBuilder(TOK, V)


@pytest.fixture
def jax_json_digits(monkeypatch):
    monkeypatch.setattr(jax_grammar, "_DIGITS", b"0123456789")


def _json_docs(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)

    def value(depth):
        k = int(rng.integers(0, 7 if depth < 3 else 4))
        if k == 0:
            return int(rng.integers(-5000, 5000))
        if k == 1:
            return float(np.round(rng.standard_normal() * 10 ** int(rng.integers(-3, 6)), 3))
        if k == 2:
            return "".join(rng.choice(["a", "b", "é", "日", "\"", "\\", "/", "\n", "z"],
                                      int(rng.integers(0, 6))))
        if k == 3:
            return [None, True, False][int(rng.integers(3))]
        if k in (4, 5):
            return {f"k{j}": value(depth + 1) for j in range(int(rng.integers(0, 4)))}
        return [value(depth + 1) for _ in range(int(rng.integers(0, 4)))]

    docs = [json.dumps({"a": value(0), "bb": value(0)}, ensure_ascii=bool(i % 2),
                       indent=None if i % 3 else 1) for i in range(3)]
    return docs + ['{"n": -1.5e+3, "m": 2E-2, "z": 0}', '{ "u": "\\u00e9\\n", "v" : [ ] }']


REGEXES = {
    r"[a-z]{2,5}@(foo|bar)\.com": lambda r: "".join(r.choice(list("abcxyz"), r.integers(2, 6)))
    + "@" + ["foo", "bar"][r.integers(2)] + ".com",
    r"\d{3}-\d{4}": lambda r: f"{r.integers(100, 1000)}-{r.integers(1000, 10000)}",
    r"(ab|cd)*e?[^x]+": lambda r: "".join(r.choice(["ab", "cd"], r.integers(0, 4)))
    + "e" * int(r.integers(2)) + "".join(r.choice(list("yzé日 "), r.integers(1, 5))),
    r"\w+ (is|was) [0-9]{1,3}(\.[0-9]+)?": lambda r: "temp_1 " + ["is", "was"][r.integers(2)]
    + f" {r.integers(0, 999)}" + (f".{r.integers(0, 99)}" if r.integers(2) else ""),
}
LARK = """
start: value
value: dict | list | STRING | NUMBER
dict: "{" pair ("," pair)* "}" | "{" "}"
pair: STRING ":" value
list: "[" (value ("," value)*)? "]"
STRING: /"[a-zé]*"/
NUMBER: /-?[0-9]+/
"""
LARK_TEXTS = ['{"ab":[1,-22,"é"],"c":{}}', '[]', '"xyz"', '[[3],{"q":"r"},7]']
CHOICES = ["yes", "yesterday", "no", "né", "日本語"]


def _walk(port_c, jax_c, text: str) -> None:
    """Masks equal at every byte state of ``text``; at each state, a token
    allowed and one not take both recognizers alike."""
    ps, js = port_c.initial(), jax_c.initial()
    rng = np.random.default_rng(len(text))
    data = text.encode("utf-8")
    for i in range(len(data) + 1):
        pm, jm = PORT.mask(port_c, ps, EOS), JAX.mask(jax_c, js, EOS)
        assert pm.dtype == jm.dtype == bool
        np.testing.assert_array_equal(pm, jm, err_msg=f"{text!r} at byte {i}")
        assert pm[list(EOS)].all() == port_c.is_complete(ps) == jax_c.is_complete(js)
        for pool in (np.flatnonzero(pm), np.flatnonzero(~pm)):
            if pool.size:
                t = int(rng.choice(pool))
                pn = PORT.advance_with_token(port_c, ps, t)
                jn = JAX.advance_with_token(jax_c, js, t)
                assert (pn is None) == (jn is None), (text, i, t)
                if pn is not None:
                    np.testing.assert_array_equal(PORT.mask(port_c, pn, EOS),
                                                  JAX.mask(jax_c, jn, EOS))
        if i < len(data):
            ps, js = port_c.advance(ps, data[i]), jax_c.advance(js, data[i])
            assert ps is not None and js is not None, (text, i)
    assert port_c.is_complete(ps) and jax_c.is_complete(js)


def test_vocab_covers_the_cases():
    lengths = [len(b) for b in PORT.token_bytes]
    assert PORT.token_bytes == JAX.token_bytes and max(lengths) > 6  # multi-byte characters
    assert sum(1 for b in PORT.token_bytes if not b) == 3


@pytest.mark.parametrize("root", ["object", "any"])
def test_json_masks_match_jax(root, jax_json_digits):
    docs = _json_docs(1)
    if root == "any":
        docs = docs[:2] + ["[1, 2.5, \"x\"]", "-0.5e3 ", "true", "\"only\""]
    for doc in docs:
        _walk(grammar.JsonConstraint(root), jax_grammar.JsonConstraint(root), doc)


@pytest.mark.parametrize("pattern", list(REGEXES))
def test_regex_masks_match_jax(pattern):
    rng = np.random.default_rng(2)
    for _ in range(3):
        _walk(grammar.RegexConstraint(pattern), jax_grammar.RegexConstraint(pattern),
              REGEXES[pattern](rng))


def test_choice_masks_match_jax():
    for text in CHOICES:
        _walk(grammar.ChoiceConstraint(CHOICES), jax_grammar.ChoiceConstraint(CHOICES), text)


def test_lark_masks_match_jax():
    port_c, jax_c = LarkConstraint(LARK), JaxLark(LARK)
    for text in LARK_TEXTS:
        _walk(port_c, jax_c, text)


def test_jax_json_refuses_digits():
    """ROADMAP Queue 3: the JAX recognizer dies at the first digit outside a
    string; the port's takes the number."""
    text = b'{"a": 1}'
    jc, pc = jax_grammar.JsonConstraint(), grammar.JsonConstraint()
    js, ps = jc.initial(), pc.initial()
    for i, by in enumerate(text):
        js, ps = (jc.advance(js, by) if js is not None else None), pc.advance(ps, by)
        assert ps is not None
        assert (js is None) == (i >= text.index(b"1"))
    assert pc.is_complete(ps)


def _dry_cases(seed: int):
    rng = np.random.default_rng(seed)
    for i in range(12):
        base = [int(x) for x in rng.integers(0, 12, int(rng.integers(2, 30)))]
        ctx = base + base[: int(rng.integers(1, len(base) + 1))]  # a repeated stretch
        breakers = tuple(int(x) for x in rng.integers(0, 12, i % 3))
        yield ctx, dict(dry_multiplier=float(rng.uniform(0.5, 2)),
                        dry_base=float(rng.uniform(1.1, 2.5)),
                        dry_allowed_length=int(rng.integers(1, 4)),
                        dry_sequence_breaker_ids=breakers)


@pytest.mark.parametrize("breakers", [False, True])
def test_dry_penalty_row_matches_jax(breakers):
    n = 0
    for ctx, kw in _dry_cases(3 + breakers):
        if not breakers:
            kw["dry_sequence_breaker_ids"] = ()
        elif not kw["dry_sequence_breaker_ids"]:
            continue
        got = dry_penalty_row(ctx, SamplingParams(**kw), 16)
        want = jax_dry(ctx, JaxParams(**kw), 16)
        assert (got is None) == (want is None), (ctx, kw)
        if got is not None:
            n += 1
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert n >= 3
    assert dry_penalty_row([1, 2], SamplingParams(), 16) is None  # off at multiplier 0
