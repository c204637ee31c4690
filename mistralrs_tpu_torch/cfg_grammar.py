"""Lark-style context-free grammar constraints (a copy of
``mistralrs_tpu/cfg_grammar.py``) — the analog of the reference's
llguidance Lark grammars (`mistralrs-core/src/sampler.rs`
CustomGrammar::Lark).

Grammar syntax (a practical Lark subset):

    start: value
    value: dict | list | STRING
    dict: "{" pair ("," pair)* "}" | "{" "}"
    pair: STRING ":" value
    STRING: /"[a-z]*"/

- rules: ``name: alternation`` (lowercase = nonterminal by convention, but
  any name works; the distinguished start rule is ``start``)
- alternations ``|``; sequences by juxtaposition; groups ``( ... )``
- terminals: ``"literal"`` strings and ``/regex/`` patterns (the byte-level
  regex engine from `grammar.py`)
- postfix ``?`` ``*`` ``+`` on any symbol or group

Recognition is an incremental byte-level Earley parser: the constraint
state is the Earley chart, terminals are run as byte automata inside items,
and ``is_complete`` holds when a finished ``start`` item spans the whole
input. Plugs into the same `TokenMaskBuilder` masking machinery as the
JSON/regex constraints.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from .grammar import RegexConstraint

# --- grammar AST -----------------------------------------------------------


@dataclass(frozen=True)
class _Lit:
    bytes_: bytes


@dataclass(frozen=True)
class _Rx:
    pattern: str


@dataclass(frozen=True)
class _Ref:
    name: str


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<name>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<lit>"(?:[^"\\]|\\.)*")
      | (?P<rx>/(?:[^/\\]|\\.)*/)
      | (?P<op>[|()?*+])
    )""",
    re.VERBOSE,
)


class _RuleParser:
    def __init__(self, text: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                if text[pos:].strip():
                    raise ValueError(f"grammar: cannot parse {text[pos:]!r}")
                break
            pos = m.end()
            for kind in ("name", "lit", "rx", "op"):
                v = m.group(kind)
                if v is not None:
                    self.toks.append((kind, v))
                    break
        self.i = 0

    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def _take(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse_alt(self, grammar: "CfgGrammar", ctx: str) -> list[list]:
        alts = [self.parse_seq(grammar, ctx)]
        while self._peek() == ("op", "|"):
            self._take()
            alts.append(self.parse_seq(grammar, ctx))
        return alts

    def parse_seq(self, grammar: "CfgGrammar", ctx: str) -> list:
        seq = []
        while True:
            kind, v = self._peek()
            if kind is None or v in ("|", ")"):
                return seq
            seq.append(self.parse_symbol(grammar, ctx))

    def parse_symbol(self, grammar: "CfgGrammar", ctx: str):
        kind, v = self._take()
        if kind == "name":
            sym = _Ref(v)
        elif kind == "lit":
            sym = _Lit(
                v[1:-1].encode().decode("unicode_escape").encode("utf-8")
            )
        elif kind == "rx":
            sym = _Rx(v[1:-1].replace("\\/", "/"))
        elif v == "(":
            alts = self.parse_alt(grammar, ctx)
            if self._take() != ("op", ")"):
                raise ValueError("grammar: unterminated group")
            sym = _Ref(grammar._anon(ctx, alts))
        else:
            raise ValueError(f"grammar: unexpected {v!r}")
        while self._peek()[0] == "op" and self._peek()[1] in "?*+":
            _, op = self._take()
            sym = _Ref(grammar._quantified(ctx, sym, op))
        return sym


class CfgGrammar:
    """Parsed grammar: rules[name] = list of alternative symbol sequences."""

    def __init__(self, text: str, start: str = "start"):
        self.rules: dict[str, list[list]] = {}
        self.start = start
        self._anon_n = 0
        pending: list[tuple[str, str]] = []
        current: Optional[str] = None
        body = ""
        for raw in text.splitlines():
            line = raw.split("//")[0].rstrip()
            if not line.strip():
                continue
            m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$", line.strip())
            if m and not raw[:1].isspace():
                if current is not None:
                    pending.append((current, body))
                current, body = m.group(1), m.group(2)
            else:
                body += " " + line.strip()
        if current is not None:
            pending.append((current, body))
        for name, rhs in pending:
            self.rules.setdefault(name, []).extend(
                _RuleParser(rhs).parse_alt(self, name)
            )
        if start not in self.rules:
            raise ValueError(f"grammar: no {start!r} rule")
        missing = {
            s.name
            for alts in self.rules.values()
            for seq in alts
            for s in seq
            if isinstance(s, _Ref) and s.name not in self.rules
        }
        if missing:
            raise ValueError(f"grammar: undefined rules {sorted(missing)}")

    def _anon(self, ctx: str, alts: list[list]) -> str:
        name = f"__{ctx}_{self._anon_n}"
        self._anon_n += 1
        self.rules[name] = alts
        return name

    def _quantified(self, ctx: str, sym, op: str) -> str:
        name = f"__{ctx}_{self._anon_n}"
        self._anon_n += 1
        if op == "?":
            self.rules[name] = [[sym], []]
        elif op == "*":
            self.rules[name] = [[sym, _Ref(name)], []]
        else:  # +
            self.rules[name] = [[sym, _Ref(name)], [sym]]
        return name


# --- incremental Earley recognition ---------------------------------------

# item: (rule_name, alt_idx, dot, origin_set, term_state)
#   term_state is None (dot rests between symbols) or the in-progress
#   terminal's automaton state (int progress for literals, NFA state set
#   for regexes)


class LarkConstraint:
    """CFG recognizer with the byte-level constraint interface
    (initial / advance / is_complete) used by `TokenMaskBuilder`."""

    name = "lark"

    def __init__(self, grammar: str | CfgGrammar, start: str = "start"):
        self.g = grammar if isinstance(grammar, CfgGrammar) else CfgGrammar(
            grammar, start
        )
        self._rx: dict[str, RegexConstraint] = {}
        for alts in self.g.rules.values():
            for seq in alts:
                for s in seq:
                    if isinstance(s, _Rx) and s.pattern not in self._rx:
                        self._rx[s.pattern] = RegexConstraint(s.pattern)

    # chart: tuple of frozensets of items
    def initial(self):
        seed = set()
        for ai in range(len(self.g.rules[self.g.start])):
            seed.add((self.g.start, ai, 0, 0, None))
        chart = [self._closure(seed, [set()], 0)]
        return (frozenset(chart[0]),)

    def _sym(self, rule, alt, dot):
        seq = self.g.rules[rule][alt]
        return seq[dot] if dot < len(seq) else None

    def _closure(self, items: set, chart, pos: int) -> set:
        """Predict + complete until a fixed point within set `pos`."""
        work = list(items)
        out = set(items)
        while work:
            rule, alt, dot, org, ts = work.pop()
            if ts is not None:
                continue
            nxt = self._sym(rule, alt, dot)
            if nxt is None:  # completed rule → advance waiting parents
                parents = chart[org] if org < len(chart) else out
                src = out if org == pos else parents
                for p in list(src):
                    pr, pa, pd, po, pts = p
                    if pts is None and isinstance(self._sym(pr, pa, pd), _Ref) \
                            and self._sym(pr, pa, pd).name == rule:
                        item = (pr, pa, pd + 1, po, None)
                        if item not in out:
                            out.add(item)
                            work.append(item)
            elif isinstance(nxt, _Ref):
                for ai in range(len(self.g.rules[nxt.name])):
                    item = (nxt.name, ai, 0, pos, None)
                    if item not in out:
                        out.add(item)
                        work.append(item)
                # nullable completion: if the referenced rule has an empty
                # alternative chain already completed in this set
                for it in list(out):
                    if (it[0] == nxt.name and it[3] == pos and it[4] is None
                            and self._sym(it[0], it[1], it[2]) is None):
                        item = (rule, alt, dot + 1, org, None)
                        if item not in out:
                            out.add(item)
                            work.append(item)
        return out

    def advance(self, state, byte: int):
        chart = [set(s) for s in state]
        pos = len(chart) - 1
        nxt: set = set()
        for rule, alt, dot, org, ts in chart[pos]:
            sym = self._sym(rule, alt, dot)
            if ts is None:
                if isinstance(sym, _Lit):
                    if sym.bytes_ and sym.bytes_[0] == byte:
                        if len(sym.bytes_) == 1:
                            nxt.add((rule, alt, dot + 1, org, None))
                        else:
                            nxt.add((rule, alt, dot, org, 1))
                elif isinstance(sym, _Rx):
                    rx = self._rx[sym.pattern]
                    st = rx.advance(rx.initial(), byte)
                    if st is not None:
                        if rx.is_complete(st):
                            nxt.add((rule, alt, dot + 1, org, None))
                        nxt.add((rule, alt, dot, org, st))
            else:
                if isinstance(sym, _Lit):
                    if sym.bytes_[ts] == byte:
                        if ts + 1 == len(sym.bytes_):
                            nxt.add((rule, alt, dot + 1, org, None))
                        else:
                            nxt.add((rule, alt, dot, org, ts + 1))
                elif isinstance(sym, _Rx):
                    rx = self._rx[sym.pattern]
                    st = rx.advance(ts, byte)
                    if st is not None:
                        if rx.is_complete(st):
                            nxt.add((rule, alt, dot + 1, org, None))
                        nxt.add((rule, alt, dot, org, st))
        if not nxt:
            return None
        chart.append(self._closure(nxt, chart, pos + 1))
        return tuple(frozenset(s) for s in chart)

    def is_complete(self, state) -> bool:
        last = state[-1]
        return any(
            rule == self.g.start and org == 0 and ts is None
            and self._sym(rule, alt, dot) is None
            for rule, alt, dot, org, ts in last
        )
