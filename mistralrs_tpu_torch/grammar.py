"""Grammar-constrained sampling (counterpart of ``mistralrs_tpu/grammar.py``;
the analog of the reference's llguidance integration,
`mistralrs-core/src/pipeline/llg.rs` + mask application in
`sampling.rs:820-831`): per-step vocabulary masks driven by an incremental
recognizer.

The recognizers are copies of the JAX package's:
* :class:`JsonConstraint` — byte-level pushdown validator for JSON
  (``response_format={"type": "json_object"}`` and forced tool-call JSON);
* :class:`ChoiceConstraint` — one of a fixed set of strings (enum-style
  forced outputs, e.g. tool names);
* :class:`RegexConstraint` — full match of a regex, a byte-level Thompson
  NFA run as a subset automaton.

The engine consults the constraint before each step: tokens whose byte
expansion would take the recognizer into a dead state are masked to
−1e30; committed tokens advance the recognizer (llg.rs commit analog).

:class:`TokenMaskBuilder` gives the JAX package's allow-mask bit for bit
but computes it another way: the JAX builder simulates every live token's
bytes in Python, this one interns the recognizer's states (by value) into
small integer ids per constraint, keeps a lazily filled transition table
``[state id, byte] -> state id`` and walks all tokens at once, one byte
column at a time, with numpy. Python runs ``advance`` once per distinct
(state, byte) pair a mask meets for the first time, and the table outlives
the step, so a mask costs a few numpy passes over the ``[V, longest token]``
byte matrix.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import numpy as np

# --- JSON pushdown recognizer ----------------------------------------------

_WS = b" \t\n\r"
# the JSON digits as bytes (JAX names them `_DIGITS` and rebinds that name to
# the regex's frozenset of ints below, so its JSON recognizer takes no digit
# outside a string: ROADMAP Queue 3)
_JSON_DIGITS = b"0123456789"
_HEX = b"0123456789abcdefABCDEF"

# stack frames
_VAL = "val"  # expecting a value
_OBJ_KEY_OR_END = "obj_key_or_end"
_OBJ_KEY = "obj_key"  # expecting a key string
_OBJ_COLON = "obj_colon"
_OBJ_COMMA_OR_END = "obj_comma_or_end"
_ARR_VAL_OR_END = "arr_val_or_end"
_ARR_COMMA_OR_END = "arr_comma_or_end"
_STR = "str"  # inside a string
_STR_ESC = "str_esc"
_STR_U = "str_u"  # \uXXXX (count in aux)
_NUM = "num"
_LIT = "lit"  # true/false/null remainder in aux
_DONE = "done"


class JsonState:
    """Immutable-ish recognizer state: (stack tuple, aux)."""

    __slots__ = ("stack", "aux")

    def __init__(self, stack=( _VAL,), aux=""):
        self.stack = stack
        self.aux = aux

    def key(self):
        return (self.stack, self.aux)


class JsonConstraint:
    """Byte-level incremental JSON recognizer.

    ``root="object"`` restricts the top-level value to a JSON object
    (OpenAI ``json_object`` mode); ``root="any"`` allows any JSON value.
    The recognizer is deliberately slightly permissive (leading zeros,
    ``-`` without digit) — it must never block valid JSON.
    """

    name = "json"

    def __init__(self, root: str = "object"):
        self.root = root

    def initial(self) -> JsonState:
        if self.root == "object":
            return JsonState((_ROOT_OBJ,))
        return JsonState()

    def is_complete(self, st: JsonState) -> bool:
        return len(st.stack) == 1 and st.stack[0] == _DONE

    # -- transition ---------------------------------------------------------

    def advance(self, st: JsonState, byte: int) -> Optional[JsonState]:
        """Next state after `byte`, or None (dead)."""
        stack, aux = st.stack, st.aux
        if not stack:
            return None
        top = stack[-1]
        c = bytes([byte])

        def push(*frames):
            return JsonState(stack[:-1] + frames, "")

        def pop():
            return JsonState(stack[:-1], "")

        if top == _DONE:
            if c in _WS:
                return st
            return None
        if top == _ROOT_OBJ:
            if c in _WS:
                return st
            if byte == 0x7B:  # {
                return JsonState((_DONE, _OBJ_KEY_OR_END), "")
            return None
        if top == _STR:
            if byte == 0x22:  # closing quote
                return pop()
            if byte == 0x5C:
                return push(_STR_ESC)
            if byte < 0x20:
                return None
            return st
        if top == _STR_ESC:
            if c in b'"\\/bfnrt':
                return push(_STR)
            if c == b"u":
                return JsonState(stack[:-1] + (_STR_U,), "4")
            return None
        if top == _STR_U:
            if c in _HEX:
                left = int(aux) - 1
                if left == 0:
                    return push(_STR)
                return JsonState(stack, str(left))
            return None
        if top == _NUM:
            # aux tracks num phase: i=int part, f=frac, e=exp, E=exp-start,
            # d=need-digit-after-dot
            if c in _JSON_DIGITS:
                return JsonState(stack, {"d": "f", "E": "e"}.get(aux, aux))
            if c == b"." and aux == "i":
                return JsonState(stack, "d")
            if c in b"eE" and aux in ("i", "f"):
                return JsonState(stack, "E")
            if c in b"+-" and aux == "E":
                return JsonState(stack, "e")
            if aux in ("d", "E"):
                return None  # dangling '.'/exp start
            # number terminated by a delimiter → re-dispatch to parent
            nxt = pop()
            return self.advance(nxt, byte)
        if top == _LIT:
            if aux and c == aux[:1].encode():
                rest = aux[1:]
                if rest:
                    return JsonState(stack, rest)
                return pop()
            return None

        # structural contexts: skip whitespace
        if c in _WS:
            return st

        if top == _VAL:
            return self._start_value(stack[:-1], byte, after=())
        if top == _ARR_VAL_OR_END:
            if byte == 0x5D:  # ]
                return pop()
            return self._start_value(stack[:-1], byte, after=(_ARR_COMMA_OR_END,))
        if top == _ARR_COMMA_OR_END:
            if byte == 0x5D:
                return pop()
            if byte == 0x2C:  # ,
                return push(_ARR_COMMA_OR_END_VALUE)
            return None
        if top == _ARR_COMMA_OR_END_VALUE:
            return self._start_value(stack[:-1], byte, after=(_ARR_COMMA_OR_END,))
        if top == _OBJ_KEY_OR_END:
            if byte == 0x7D:  # }
                return pop()
            if byte == 0x22:
                return JsonState(stack[:-1] + (_OBJ_COLON, _STR), "")
            return None
        if top == _OBJ_COLON:
            if byte == 0x3A:  # :
                return push(_OBJ_COLON_VALUE)
            return None
        if top == _OBJ_COLON_VALUE:
            return self._start_value(stack[:-1], byte, after=(_OBJ_COMMA_OR_END,))
        if top == _OBJ_COMMA_OR_END:
            if byte == 0x7D:
                return pop()
            if byte == 0x2C:
                return push(_OBJ_KEY)
            return None
        if top == _OBJ_KEY:
            if byte == 0x22:
                return JsonState(stack[:-1] + (_OBJ_COLON, _STR), "")
            return None
        return None

    def _start_value(self, below: tuple, byte: int, after: tuple):
        """Begin a JSON value; `after` frames resume once it completes."""
        base = below + (after if after else (() if below else (_DONE,)))
        c = bytes([byte])
        if byte == 0x7B:  # {
            return JsonState(base + (_OBJ_KEY_OR_END,), "")
        if byte == 0x5B:  # [
            return JsonState(base + (_ARR_VAL_OR_END,), "")
        if byte == 0x22:
            return JsonState(base + (_STR,), "")
        if c in _JSON_DIGITS:
            return JsonState(base + (_NUM,), "i")
        if byte == 0x2D:  # -
            return JsonState(base + (_NUM,), "i")
        if c == b"t":
            return JsonState(base + (_LIT,), "rue")
        if c == b"f":
            return JsonState(base + (_LIT,), "alse")
        if c == b"n":
            return JsonState(base + (_LIT,), "ull")
        return None


_ARR_COMMA_OR_END_VALUE = "arr_comma_value"
_OBJ_COLON_VALUE = "obj_colon_value"
_ROOT_OBJ = "root_obj"


class ChoiceConstraint:
    """Output must be exactly one of the given strings."""

    name = "choice"

    def __init__(self, choices: Sequence[str]):
        self.choices = [c.encode() for c in choices]

    def initial(self):
        return b""  # committed prefix

    def is_complete(self, st: bytes) -> bool:
        return any(st == c for c in self.choices)

    def advance(self, st: bytes, byte: int) -> Optional[bytes]:
        nxt = st + bytes([byte])
        if any(c.startswith(nxt) for c in self.choices):
            return nxt
        return None


# --- regex constraints ------------------------------------------------------


class _NfaNode:
    __slots__ = ("edges", "eps", "accept")

    def __init__(self):
        self.edges: list[tuple[frozenset, "_NfaNode"]] = []  # (byte set, target)
        self.eps: list["_NfaNode"] = []
        self.accept = False


_ALL_BYTES = frozenset(range(256))
_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    set(range(ord("a"), ord("z") + 1))
    | set(range(ord("A"), ord("Z") + 1))
    | set(range(ord("0"), ord("9") + 1))
    | {ord("_")}
)
_SPACE = frozenset(map(ord, " \t\n\r\f\v"))
_ESCAPES = {
    "d": _DIGITS, "D": _ALL_BYTES - _DIGITS,
    "w": _WORD, "W": _ALL_BYTES - _WORD,
    "s": _SPACE, "S": _ALL_BYTES - _SPACE,
    "n": frozenset({10}), "t": frozenset({9}), "r": frozenset({13}),
}
_MAX_REPEAT = 256


class _RegexParser:
    """Recursive-descent regex → Thompson NFA fragments (start, out-node).

    Supported subset (the practical constrained-decoding core, byte-level
    over UTF-8): literals, ``.``, ``[...]`` classes with ranges and negation,
    ``\\d \\w \\s`` (+ negations), groups, ``|``, ``* + ?``, ``{m}``,
    ``{m,}``, ``{m,n}``. Anchors the whole pattern (fullmatch semantics, like
    the reference's llguidance regex constraint).
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self):
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> tuple[_NfaNode, _NfaNode]:
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"regex: unexpected {self.p[self.i]!r} at {self.i}")
        return frag

    def _alt(self):
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, o = _NfaNode(), _NfaNode()
        for fs, fo in frags:
            s.eps.append(fs)
            fo.eps.append(o)
        return s, o

    def _concat(self):
        frags = []
        while self._peek() not in (None, "|", ")"):
            frags.append(self._repeat())
        if not frags:
            n = _NfaNode()
            return n, n
        s, o = frags[0]
        for fs, fo in frags[1:]:
            o.eps.append(fs)
            o = fo
        return s, o

    def _repeat(self):
        frag = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._take()
                frag = self._star(frag)
            elif c == "+":
                self._take()
                s2, o2 = self._star(self._clone(frag))
                fs, fo = frag
                fo.eps.append(s2)
                frag = (fs, o2)
            elif c == "?":
                self._take()
                fs, fo = frag
                s, o = _NfaNode(), _NfaNode()
                s.eps.extend([fs, o])
                fo.eps.append(o)
                frag = (s, o)
            elif c == "{":
                frag = self._bounded(frag)
            else:
                return frag

    def _star(self, frag):
        fs, fo = frag
        s, o = _NfaNode(), _NfaNode()
        s.eps.extend([fs, o])
        fo.eps.extend([fs, o])
        return s, o

    def _bounded(self, frag):
        self._take()  # {
        spec = ""
        while self._peek() not in (None, "}"):
            spec += self._take()
        if self._peek() != "}":
            raise ValueError("regex: unterminated {}")
        self._take()
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s or 0)
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(spec)
        if hi is not None and (hi < lo or hi > _MAX_REPEAT):
            raise ValueError(f"regex: bad repeat {{{spec}}}")
        parts = [self._clone(frag) for _ in range(max(lo, 1) if lo else 0)]
        s = o = None
        for fs, fo in parts:
            if s is None:
                s, o = fs, fo
            else:
                o.eps.append(fs)
                o = fo
        if s is None:
            s = o = _NfaNode()
        if hi is None:  # {m,} → m copies + star
            ss, so = self._star(self._clone(frag))
            o.eps.append(ss)
            o = so
        else:
            for _ in range(hi - lo):
                fs, fo = self._clone(frag)
                opt_o = _NfaNode()
                o.eps.extend([fs, opt_o])
                fo.eps.append(opt_o)
                o = opt_o
        return s, o

    def _clone(self, frag):
        """Deep-copy an NFA fragment (for bounded repetition)."""
        fs, fo = frag
        mapping: dict[int, _NfaNode] = {}

        def copy(n: _NfaNode) -> _NfaNode:
            if id(n) in mapping:
                return mapping[id(n)]
            m = _NfaNode()
            mapping[id(n)] = m
            m.accept = n.accept
            for pred, tgt in n.edges:
                m.edges.append((pred, copy(tgt)))
            m.eps.extend(copy(t) for t in n.eps)
            return m

        return copy(fs), mapping[id(fo)] if id(fo) in mapping else copy(fo)

    def _atom(self):
        c = self._take()
        if c == "(":
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2  # non-capturing — groups never capture here
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("regex: unterminated group")
            self._take()
            return frag
        if c == "[":
            return self._char_class()
        if c == ".":
            return self._edge(_ALL_BYTES - frozenset({10}))
        if c == "\\":
            e = self._take()
            if e in _ESCAPES:
                return self._edge(_ESCAPES[e])
            return self._literal(e)
        if c in ")|*+?{":
            raise ValueError(f"regex: unexpected {c!r}")
        return self._literal(c)

    def _literal(self, ch: str):
        bts = ch.encode("utf-8")
        s = _NfaNode()
        node = s
        for by in bts:
            nxt = _NfaNode()
            node.edges.append((frozenset({by}), nxt))
            node = nxt
        return s, node

    def _edge(self, byte_set: frozenset):
        s, o = _NfaNode(), _NfaNode()
        s.edges.append((byte_set, o))
        return s, o

    def _char_class(self):
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        members: set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("regex: unterminated [")
            if c == "]" and not first:
                self._take()
                break
            first = False
            c = self._take()
            if c == "\\":
                e = self._take()
                if e in _ESCAPES:
                    members |= _ESCAPES[e]
                    continue
                c = e
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self._take()
                hi = self._take()
                if hi == "\\":
                    hi = self._take()
                members |= set(range(ord(c), ord(hi) + 1))
            else:
                members |= set(c.encode("utf-8"))
        out = frozenset(members) if not negate else _ALL_BYTES - frozenset(members)
        return self._edge(out)


class RegexConstraint:
    """Output must full-match the regex (byte-level Thompson NFA run as a
    lazily-determinized subset automaton — the analog of the reference's
    llguidance regex grammars, `mistralrs-core/src/sampler.rs` custom-grammar
    constraints)."""

    name = "regex"

    def __init__(self, pattern: str):
        self.pattern = pattern
        start, out = _RegexParser(pattern).parse()
        out.accept = True
        self._start = start

    @staticmethod
    def _closure(nodes) -> frozenset:
        out = []
        stack = list(nodes)
        visited = set()
        while stack:
            n = stack.pop()
            if id(n) in visited:
                continue
            visited.add(id(n))
            out.append(n)
            stack.extend(n.eps)
        return frozenset(out)

    def initial(self):
        return self._closure([self._start])

    def is_complete(self, st) -> bool:
        return any(n.accept for n in st)

    def advance(self, st, byte: int):
        nxt = [t for n in st for pred, t in n.edges if byte in pred]
        if not nxt:
            return None
        return self._closure(nxt)


# --- token-level masking ----------------------------------------------------

_UNKNOWN, _DEAD = -2, -1  # transition table entries: not computed yet; dead


def state_key(state):
    """A hashable value equal for recognizer states that behave alike: a
    :class:`JsonState`'s ``key()``, else the state itself (bytes for
    :class:`ChoiceConstraint`, frozensets of NFA nodes for
    :class:`RegexConstraint`, tuples of frozensets for the Lark charts)."""
    return state.key() if isinstance(state, JsonState) else state


class _Automaton:
    """One constraint's states interned as ids ``0, 1, ...`` and its
    transition table ``[state id, byte] -> state id`` (``_DEAD`` where
    ``advance`` returns None), filled as masks meet new pairs."""

    def __init__(self, constraint):
        self.constraint = constraint
        self.ids: dict = {}
        self.states: list = []
        self.table = np.full((64, 256), _UNKNOWN, np.int32)

    def intern(self, state) -> int:
        key = state_key(state)
        i = self.ids.get(key)
        if i is None:
            i = len(self.states)
            self.ids[key] = i
            self.states.append(state)
            if i >= self.table.shape[0]:
                self.table = np.concatenate(
                    [self.table, np.full_like(self.table, _UNKNOWN)])
        return i

    def step(self, ids: np.ndarray, byts: np.ndarray) -> np.ndarray:
        """The state ids after ``byts`` from the (live) state ids ``ids``."""
        nxt = self.table[ids, byts]
        unknown = nxt == _UNKNOWN
        if unknown.any():
            pairs = np.unique(ids[unknown].astype(np.int64) * 256 + byts[unknown])
            for pair in pairs.tolist():
                s, b = divmod(pair, 256)
                st = self.constraint.advance(self.states[s], b)
                nid = _DEAD if st is None else self.intern(st)
                self.table[s, b] = nid
            nxt = self.table[ids, byts]
        return nxt


class TokenMaskBuilder:
    """Per-tokenizer token→bytes table and the allow-masks of JAX
    ``TokenMaskBuilder`` (a token is allowed when the recognizer survives
    all of its bytes; a token of no bytes never is; the EOS ids are allowed
    when the state is complete)."""

    def __init__(self, tokenizer, vocab_size: int):
        self.vocab_size = vocab_size
        self.token_bytes: list[bytes] = []
        for i in range(vocab_size):
            try:
                s = tokenizer.decode([i], skip_special_tokens=False)
            except Exception:  # noqa: BLE001
                s = ""
            self.token_bytes.append(s.encode("utf-8"))
        lengths = np.asarray([len(b) for b in self.token_bytes], np.int64)
        # tokens with bytes, longest first: the tokens that have a byte at
        # column c are then the first `counts[c]` of this order
        self._order = np.argsort(-lengths, kind="stable")[: int((lengths > 0).sum())]
        lens = lengths[self._order]
        flat = np.frombuffer(b"".join(self.token_bytes[t] for t in self._order.tolist()),
                             np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        width = int(lens[0]) if lens.size else 0
        self._counts = [int((lens > c).sum()) for c in range(width)]
        self._cols = [flat[starts[:n] + c] for c, n in enumerate(self._counts)]
        self._automata: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _automaton(self, constraint) -> _Automaton:
        try:
            auto = self._automata.get(constraint)
            if auto is None:
                auto = self._automata[constraint] = _Automaton(constraint)
        except TypeError:  # a recognizer that takes no weak reference
            auto = _Automaton(constraint)
        return auto

    def mask(self, constraint, state, eos_ids: Sequence[int]) -> np.ndarray:
        """Boolean allow-mask [V] for the current recognizer state."""
        auto = self._automaton(constraint)
        cur = np.full(self._order.size, auto.intern(state), np.int32)
        for n, col in zip(self._counts, self._cols):
            sub = cur[:n]
            live = np.flatnonzero(sub >= 0)
            if live.size == 0:
                break
            sub[live] = auto.step(sub[live], col[live])
        out = np.zeros(self.vocab_size, bool)
        out[self._order] = cur >= 0
        if constraint.is_complete(state):
            for e in eos_ids:
                if 0 <= e < self.vocab_size:
                    out[e] = True
        return out

    def advance_with_token(self, constraint, state, token_id: int):
        """Advance the recognizer over a committed token's bytes."""
        for by in self.token_bytes[token_id]:
            state = constraint.advance(state, by)
            if state is None:
                return None
        return state
