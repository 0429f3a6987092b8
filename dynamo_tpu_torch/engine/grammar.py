"""Grammar-constrained decoding: JSON-schema / regex → token-mask FSM.

The Outlines construction (Willard & Louf, arXiv:2307.09702): compile the
constraint to a character-level (here: BYTE-level) DFA once, then lift it
to a TOKEN-level FSM over the serving vocabulary — for each reachable DFA
state, a token is legal iff walking its bytes through the DFA survives.
Per-sequence decoding state is then a single integer advanced once per
emitted token, and "which tokens are legal next" is an O(1) cached-mask
lookup: exactly the shape the engine needs, because masks are gathered
host-side per verify slot and shipped to the device as packed bitsets
(XGrammar's overlap argument, arXiv:2411.15100 — the mask math is off the
critical path of the forward pass).

Pieces:

- a byte-level regex subset → Thompson NFA → lazily-determinized DFA
  (``_ByteDfa``). The subset covers everything the JSON-schema compiler
  emits plus user ``pattern`` strings: literals, ``.``, ``[...]`` classes
  with ranges/negation, escapes (``\\d \\w \\s`` + punctuation), groups,
  alternation, ``* + ?`` and ``{m}/{m,}/{m,n}`` repetition.
- ``schema_to_regex``: JSON schema → regex. Fixed canonical layout
  (properties in declared order, ``": "`` / ``", "`` separators, no other
  whitespace) — fewer legal choices per state means more FORCED tokens,
  which is what makes constrained drafting near-perfect. Bounded
  recursion depth for nested/untyped values ("json_object" mode is a
  depth-limited any-JSON grammar; JSON nesting is not regular).
- ``TokenFsm``: the token-level lift. Transitions and packed masks are
  computed lazily per reached state and cached — compile cost is paid
  per (schema, state actually visited), not per (schema, full DFA).
- ``GrammarCompiler``: schema-hash-keyed cache of compiled grammars
  (compiled once per distinct ``response_format``, shared across
  requests and sequences; thread-safe — compiles happen off the
  scheduler thread).

Terminal semantics: a state where the byte DFA accepts makes EOS legal
(its mask sets the request's EOS bits); non-terminal states mask EOS, so
a constrained stream can only ever stop on a complete match. A state
with exactly one legal token and no accept is FORCED — the drafter
fast-forwards through forced runs (JSON structure: braces, keys,
separators) without any model signal, because no other continuation can
ever be accepted.

No jax imports here: everything is host-side numpy, usable from the
frontend preprocessor (schema validation) without touching the device
stack.
"""

from __future__ import annotations

import hashlib
import json
import threading

import numpy as np

__all__ = [
    "GrammarError",
    "CompiledGrammar",
    "GrammarCompiler",
    "compile_response_format_regex",
    "schema_to_regex",
    "grammar_vocab",
    "pack_token_ids",
]

# Depth budget for nested / untyped JSON values: regular languages cannot
# count braces, so recursion is expanded to this depth and deeper nesting
# is simply not generable (json_object mode) or rejected (schemas that
# nest beyond it).
DEFAULT_JSON_DEPTH = 4
# Array items generated for schemas without maxItems (regex repetition
# must be bounded somewhere sane; explicit maxItems wins up to this cap).
DEFAULT_MAX_ITEMS = 6
# Unbounded string/number content repetition cap — long enough for real
# payloads, small enough that {m,n} expansion stays out of the picture
# (we compile * on the char class, the cap only applies to explicit
# maxLength handling).
_ANY_BYTE_LO = 0x20


class GrammarError(Exception):
    """Malformed or unsupported constraint spec (schema / regex /
    response_format). Maps to a 400 invalid_request_error at the HTTP
    boundary — typed (DT005) so the serving path never raises bare."""


# ---------------------------------------------------------------------------
# Byte-level regex subset → NFA (Thompson construction)
# ---------------------------------------------------------------------------

_CLASS_ESCAPES = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(
        list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
        + list(range(0x61, 0x7B)) + [0x5F]
    ),
    "s": frozenset((0x20, 0x09, 0x0A, 0x0D)),
    "n": frozenset((0x0A,)),
    "t": frozenset((0x09,)),
    "r": frozenset((0x0D,)),
}
# `.` (and the complement universe for negated classes): printable ASCII.
# Free-form non-ASCII would need the DFA to model multi-byte UTF-8
# sequences (else a lone continuation byte is generable and the output
# stops being valid UTF-8); constrained output is ASCII-JSON for now —
# non-ASCII payload still round-trips via \uXXXX escapes, which the
# string grammar accepts.
_DOT = frozenset(range(_ANY_BYTE_LO, 0x7F))


def _escape_set(ch: str) -> frozenset[int]:
    if ch in _CLASS_ESCAPES:
        return _CLASS_ESCAPES[ch]
    if ch in "DWS":
        # Complement over the printable-byte universe (control bytes are
        # never generable — JSON forbids them raw and nothing the schema
        # compiler emits wants them).
        return _DOT - _CLASS_ESCAPES[ch.lower()]
    # Any other ALPHANUMERIC escape (\x, \u, \b, \B, \A, backrefs, ...)
    # is a regex feature this subset does not implement — treating it as
    # a literal would silently compile the WRONG language, so reject it
    # (the frontend turns this into a 400 at validation time).
    if ch.isalnum():
        raise GrammarError(f"unsupported escape \\{ch}")
    # punctuation escape: the literal byte(s)
    b = ch.encode("utf-8")
    if len(b) != 1:
        raise GrammarError(f"unsupported escape \\{ch}")
    return frozenset(b)


class _RegexParser:
    """Recursive-descent parser for the byte-level regex subset → AST.
    AST nodes: ("set", frozenset), ("cat", [..]), ("alt", [..]),
    ("rep", node, min, max|None)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise GrammarError(f"unexpected {self.p[self.i]!r} at {self.i} in pattern")
        return node

    def _alt(self):
        branches = [self._seq()]
        while self._peek() == "|":
            self._take()
            branches.append(self._seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _seq(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("cat", [])
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        ch = self._peek()
        if ch == "*":
            self._take()
            return ("rep", node, 0, None)
        if ch == "+":
            self._take()
            return ("rep", node, 1, None)
        if ch == "?":
            self._take()
            return ("rep", node, 0, 1)
        if ch == "{":
            self._take()
            spec = ""
            while self._peek() not in (None, "}"):
                spec += self._take()
            if self._peek() != "}":
                raise GrammarError("unterminated {m,n} repetition")
            self._take()
            try:
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
            except ValueError:
                raise GrammarError(f"bad repetition {{{spec}}}") from None
            if lo < 0 or (hi is not None and hi < lo):
                raise GrammarError(f"bad repetition bounds {{{spec}}}")
            return ("rep", node, lo, hi)
        return node

    def _atom(self):
        ch = self._take() if self._peek() is not None else None
        if ch is None:
            raise GrammarError("truncated pattern")
        if ch == "(":
            # non-capturing group marker tolerated
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError("unbalanced parenthesis")
            self._take()
            return node
        if ch == "[":
            return ("set", self._char_class())
        if ch == ".":
            return ("set", _DOT)
        if ch == "\\":
            if self._peek() is None:
                raise GrammarError("trailing backslash")
            return ("set", _escape_set(self._take()))
        if ch in ")|*+?{":
            raise GrammarError(f"misplaced {ch!r} in pattern")
        b = ch.encode("utf-8")
        if len(b) == 1:
            return ("set", frozenset(b))
        # multi-byte literal: a fixed byte sequence
        return ("cat", [("set", frozenset((x,))) for x in b])

    def _char_class(self) -> frozenset[int]:
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        out: set[int] = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise GrammarError("unterminated character class")
            if ch == "]" and not first:
                self._take()
                break
            first = False
            self._take()
            if ch == "\\":
                nxt = self._take() if self._peek() is not None else None
                if nxt is None:
                    raise GrammarError("trailing backslash in class")
                if nxt.startswith("x"):
                    raise GrammarError("\\x escapes unsupported in classes")
                s = _escape_set(nxt)
                out |= s
                continue
            lo_b = ch.encode("utf-8")
            if len(lo_b) != 1:
                raise GrammarError("non-ASCII range endpoints unsupported")
            lo = lo_b[0]
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self._take()
                hi_ch = self._take()
                if hi_ch == "\\":
                    hi_ch = self._take()
                hi_b = hi_ch.encode("utf-8")
                if len(hi_b) != 1 or hi_b[0] < lo:
                    raise GrammarError(f"bad class range {ch}-{hi_ch}")
                out |= set(range(lo, hi_b[0] + 1))
            else:
                out.add(lo)
        if negate:
            # Negation complements over printable bytes (>= 0x20), not
            # the raw byte range: `[^"\\]` in a JSON-string grammar must
            # not legalize control bytes JSON forbids unescaped.
            return _DOT - frozenset(out)
        return frozenset(out)


class _Nfa:
    """Thompson NFA: states are ints; ``eps[s]`` epsilon successors,
    ``edges[s]`` list of (byteset, target)."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset[int], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, start: int, accept: int) -> None:
        kind = node[0]
        if kind == "set":
            self.edges[start].append((node[1], accept))
        elif kind == "cat":
            parts = node[1]
            if not parts:
                self.eps[start].append(accept)
                return
            cur = start
            for i, part in enumerate(parts):
                nxt = accept if i == len(parts) - 1 else self.state()
                self.build(part, cur, nxt)
                cur = nxt
        elif kind == "alt":
            for branch in node[1]:
                s, a = self.state(), self.state()
                self.eps[start].append(s)
                self.eps[a].append(accept)
                self.build(branch, s, a)
        elif kind == "rep":
            _, inner, lo, hi = node
            cur = start
            for _ in range(lo):
                nxt = self.state()
                self.build(inner, cur, nxt)
                cur = nxt
            if hi is None:
                # Kleene tail: loop state
                loop = self.state()
                self.eps[cur].append(loop)
                s, a = self.state(), self.state()
                self.eps[loop].append(s)
                self.eps[a].append(loop)
                self.build(inner, s, a)
                self.eps[loop].append(accept)
            else:
                self.eps[cur].append(accept)
                for _ in range(hi - lo):
                    nxt = self.state()
                    self.build(inner, cur, nxt)
                    self.eps[nxt].append(accept)
                    cur = nxt
        else:  # pragma: no cover - parser emits only the kinds above
            raise GrammarError(f"unknown regex node {kind!r}")


class _ByteDfa:
    """Lazily-determinized byte DFA over a Thompson NFA. States are
    interned frozensets of eps-closed NFA states; every non-empty state
    can reach acceptance (a property of the Thompson construction), so
    liveness checks reduce to "transition exists"."""

    def __init__(self, pattern: str):
        ast = _RegexParser(pattern).parse()
        self.nfa = _Nfa()
        s0, acc = self.nfa.state(), self.nfa.state()
        self.nfa.build(ast, s0, acc)
        self._accept = acc
        self._ids: dict[frozenset[int], int] = {}
        self._sets: list[frozenset[int]] = []
        self._trans: list[dict[int, int | None]] = []  # per state: byte → id|None
        self._accepting: list[bool] = []
        self.start = self._intern(self._closure({s0}))

    def _closure(self, states: set[int]) -> frozenset[int]:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for t in self.nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def _intern(self, sset: frozenset[int]) -> int:
        sid = self._ids.get(sset)
        if sid is None:
            sid = len(self._sets)
            self._ids[sset] = sid
            self._sets.append(sset)
            self._trans.append({})
            self._accepting.append(self._accept in sset)
        return sid

    def step(self, sid: int, byte: int) -> int | None:
        cache = self._trans[sid]
        if byte in cache:
            return cache[byte]
        moved: set[int] = set()
        for s in self._sets[sid]:
            for byteset, target in self.nfa.edges[s]:
                if byte in byteset:
                    moved.add(target)
        nxt = self._intern(self._closure(moved)) if moved else None
        cache[byte] = nxt
        return nxt

    def accepting(self, sid: int) -> bool:
        return self._accepting[sid]

    def walk(self, sid: int, data: bytes) -> int | None:
        for b in data:
            sid = self.step(sid, b)
            if sid is None:
                return None
        return sid


# ---------------------------------------------------------------------------
# JSON schema → regex
# ---------------------------------------------------------------------------

_REGEX_SPECIALS = set("\\^$.|?*+()[]{}")


def _lit(text: str) -> str:
    """Regex-escape a literal string."""
    return "".join("\\" + c if c in _REGEX_SPECIALS else c for c in text)


# JSON string content, byte-level: any byte >= 0x20 except '"' and '\',
# or a simple escape, or \uXXXX. Permits non-ASCII bytes raw (the byte
# tokenizer emits them; json accepts UTF-8).
_STR_CHAR = '(?:[^"\\\\]|\\\\["\\\\/bfnrt]|\\\\u[0-9a-fA-F]{4})'
# Digit runs are CAPPED (16 int / 15 frac / 3 exp digits): past the cap
# the mask forces the closing delimiter, so a greedy model that would
# otherwise ramble digits to max_tokens terminates — and JSON numbers
# past 2^53 lose precision anyway. Strings stay unbounded unless the
# schema gives maxLength.
_INT = "-?(?:0|[1-9][0-9]{0,15})"
_NUMBER = _INT + "(?:\\.[0-9]{1,15})?(?:[eE][+-]?[0-9]{1,3})?"


def _json_literal_regex(value) -> str:
    return _lit(json.dumps(value, ensure_ascii=True))


def _resolve_ref(ref: str, root: dict) -> dict:
    if not ref.startswith("#/"):
        raise GrammarError(f"only local $ref supported, got {ref!r}")
    node = root
    for part in ref[2:].split("/"):
        part = part.replace("~1", "/").replace("~0", "~")
        if not isinstance(node, dict) or part not in node:
            raise GrammarError(f"unresolvable $ref {ref!r}")
        node = node[part]
    if not isinstance(node, dict):
        raise GrammarError(f"$ref {ref!r} does not name a schema object")
    return node


def _string_regex(schema: dict) -> str:
    if "pattern" in schema:
        pat = schema["pattern"]
        if not isinstance(pat, str):
            raise GrammarError("'pattern' must be a string")
        # Anchors are implicit (the whole string matches); strip the
        # common explicit ones.
        if pat.startswith("^"):
            pat = pat[1:]
        if pat.endswith("$") and not pat.endswith("\\$"):
            pat = pat[:-1]
        _RegexParser(pat).parse()  # validate the subset up front
        return f'"(?:{pat})"'
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is None and hi is None:
        return f'"{_STR_CHAR}*"'
    lo = int(lo or 0)
    if hi is None:
        return f'"{_STR_CHAR}{{{lo},}}"'
    hi = int(hi)
    if hi < lo:
        raise GrammarError("maxLength < minLength")
    return f'"{_STR_CHAR}{{{lo},{hi}}}"'


def schema_to_regex(schema: dict, depth: int = DEFAULT_JSON_DEPTH,
                    root: dict | None = None) -> str:
    """JSON schema (the OpenAI structured-output subset) → regex over the
    canonical serialization: properties in declared order (all emitted —
    a superset of any ``required`` list), ``": "`` / ``", "`` separators,
    no other whitespace. Raises :class:`GrammarError` on unsupported
    constructs so the frontend can 400 before any engine work."""
    if root is None:
        root = schema
    if not isinstance(schema, dict):
        raise GrammarError("schema must be a JSON object")
    if "$ref" in schema:
        if depth <= 0:
            raise GrammarError("schema recursion exceeds supported depth")
        return schema_to_regex(_resolve_ref(schema["$ref"], root), depth - 1, root)
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise GrammarError("'enum' must be a non-empty array")
        return "(?:" + "|".join(_json_literal_regex(v) for v in vals) + ")"
    if "const" in schema:
        return _json_literal_regex(schema["const"])
    for comb in ("anyOf", "oneOf"):
        if comb in schema:
            subs = schema[comb]
            if not isinstance(subs, list) or not subs:
                raise GrammarError(f"'{comb}' must be a non-empty array")
            return "(?:" + "|".join(
                schema_to_regex(s, depth, root) for s in subs
            ) + ")"
    stype = schema.get("type")
    if isinstance(stype, list):
        return "(?:" + "|".join(
            schema_to_regex({**schema, "type": t}, depth, root) for t in stype
        ) + ")"
    if stype == "string":
        return _string_regex(schema)
    if stype == "integer":
        return _INT
    if stype == "number":
        return _NUMBER
    if stype == "boolean":
        return "(?:true|false)"
    if stype == "null":
        return "null"
    if stype == "object":
        if depth <= 0:
            raise GrammarError("schema nests deeper than the supported depth")
        props = schema.get("properties") or {}
        if not isinstance(props, dict):
            raise GrammarError("'properties' must be an object")
        if not props:
            return "\\{\\}"
        parts = []
        for key, sub in props.items():
            parts.append(_lit(json.dumps(str(key))) + ": "
                         + schema_to_regex(sub if isinstance(sub, dict) else {},
                                           depth - 1, root))
        return "\\{" + ", ".join(parts) + "\\}"
    if stype == "array":
        if depth <= 0:
            raise GrammarError("schema nests deeper than the supported depth")
        item = schema.get("items")
        item_re = schema_to_regex(item if isinstance(item, dict) else {},
                                  depth - 1, root)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", DEFAULT_MAX_ITEMS))
        if hi < lo:
            raise GrammarError("maxItems < minItems")
        hi = max(hi, lo)
        body_req = ", ".join([f"(?:{item_re})"] * lo) if lo else ""
        extra = hi - lo
        if extra:
            opt = f"(?:, (?:{item_re}))" if lo else None
            if lo:
                tail = f"{opt}{{0,{extra}}}"
                body = body_req + tail
            else:
                body = f"(?:(?:{item_re})(?:, (?:{item_re})){{0,{extra - 1}}})?"
        else:
            body = body_req
        return "\\[" + body + "\\]"
    if stype is None:
        # untyped: any JSON value at the remaining depth
        return _any_value_regex(depth)
    raise GrammarError(f"unsupported schema type {stype!r}")


def _any_value_regex(depth: int) -> str:
    scalar = f'(?:"{_STR_CHAR}*"|{_NUMBER}|true|false|null)'
    if depth <= 0:
        return scalar
    inner = _any_value_regex(depth - 1)
    obj = f'(?:\\{{\\}}|\\{{"{_STR_CHAR}+": {inner}(?:, "{_STR_CHAR}+": {inner}){{0,{DEFAULT_MAX_ITEMS - 1}}}\\}})'
    arr = f"(?:\\[\\]|\\[{inner}(?:, {inner}){{0,{DEFAULT_MAX_ITEMS - 1}}}\\])"
    return f"(?:{scalar}|{obj}|{arr})"


def compile_response_format_regex(rf: dict) -> str | None:
    """OpenAI ``response_format`` dict → constraint regex (None when the
    format imposes no constraint). Raises GrammarError on malformed or
    unsupported specs — the frontend maps that to a 400."""
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    ftype = rf.get("type")
    if ftype == "text" or ftype is None:
        return None
    if ftype == "json_object":
        # Any JSON object (depth-bounded): the classic "JSON mode".
        inner = _any_value_regex(DEFAULT_JSON_DEPTH - 1)
        return (f'\\{{\\}}|\\{{"{_STR_CHAR}+": {inner}'
                f'(?:, "{_STR_CHAR}+": {inner}){{0,{DEFAULT_MAX_ITEMS - 1}}}\\}}')
    if ftype == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            raise GrammarError("response_format.json_schema must be an object")
        schema = js.get("schema")
        if not isinstance(schema, dict):
            raise GrammarError("response_format.json_schema.schema must be an object")
        return schema_to_regex(schema)
    raise GrammarError(f"unsupported response_format type {ftype!r}")


# ---------------------------------------------------------------------------
# Token-level FSM over a vocabulary
# ---------------------------------------------------------------------------


def grammar_vocab(tokenizer) -> dict[int, bytes]:
    """Tokenizer → {token_id: byte string} for every text-producing
    token. Tokens that produce no bytes (specials) are never grammar-
    legal; EOS legality is handled separately via the terminal-state
    mask. ByteTokenizer maps directly (token i < 256 IS byte i — decode
    would lose non-UTF-8 bytes to replacement chars); other tokenizers
    go through best-effort per-id decode."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    if isinstance(tokenizer, ByteTokenizer):
        return {i: bytes([i]) for i in range(256)}
    out: dict[int, bytes] = {}
    eos = set(tokenizer.eos_token_ids)
    for tid in range(tokenizer.vocab_size):
        if tid in eos:
            continue
        try:
            text = tokenizer.decode([tid], skip_special_tokens=True)
        except Exception:  # noqa: BLE001 — unknown ids in sparse vocabs just stay illegal
            continue
        if text:
            out[tid] = text.encode("utf-8")
    return out


def pack_token_ids(ids, vocab_size: int) -> np.ndarray:
    """Set of token ids → packed uint32 bitset [ceil(V/32)]."""
    words = (vocab_size + 31) // 32
    out = np.zeros((words,), np.uint32)
    for t in ids:
        t = int(t)
        if 0 <= t < vocab_size:
            out[t >> 5] |= np.uint32(1 << (t & 31))
    return out


def mask_words(vocab_size: int) -> int:
    return (vocab_size + 31) // 32


class CompiledGrammar:
    """One compiled constraint: byte DFA + token-level lift, shared by
    every sequence using the same schema. Thread-safe: lazy state
    computation happens under a lock (compiles run off the scheduler
    thread; per-token advance/mask hits only cached dicts)."""

    def __init__(self, regex: str, vocab: dict[int, bytes], vocab_size: int,
                 spec_hash: str):
        self.hash = spec_hash
        self.vocab_size = vocab_size
        self._vocab = vocab
        self._dfa = _ByteDfa(regex)
        self.start = self._dfa.start
        self._lock = threading.Lock()
        # per byte-DFA state id: {token_id: next_state}
        self._token_trans: dict[int, dict[int, int]] = {}
        # per state id: packed legal-token bitset (WITHOUT eos bits)
        self._base_masks: dict[int, np.ndarray] = {}
        self._forced: dict[int, int | None] = {}

    # -- lazy state lift ---------------------------------------------------

    def _lift(self, state: int) -> dict[int, int]:
        trans = self._token_trans.get(state)
        if trans is not None:
            return trans
        with self._lock:
            trans = self._token_trans.get(state)
            if trans is not None:
                return trans
            trans = {}
            for tid, data in self._vocab.items():
                nxt = self._dfa.walk(state, data)
                if nxt is not None:
                    trans[tid] = nxt
            mask = pack_token_ids(trans.keys(), self.vocab_size)
            forced = None
            if len(trans) == 1 and not self._dfa.accepting(state):
                forced = next(iter(trans))
            self._base_masks[state] = mask
            self._forced[state] = forced
            self._token_trans[state] = trans
            return trans

    # -- per-sequence API --------------------------------------------------

    def advance(self, state: int, token_id: int) -> int | None:
        """FSM state after emitting ``token_id`` (None = illegal — cannot
        happen for masked-sampled tokens; callers treat it defensively)."""
        return self._lift(state).get(int(token_id))

    def legal(self, state: int, token_id: int) -> bool:
        return int(token_id) in self._lift(state)

    def is_terminal(self, state: int) -> bool:
        """True when the match is complete here — EOS becomes legal."""
        return self._dfa.accepting(state)

    def forced(self, state: int) -> int | None:
        """The single legal continuation at a non-terminal state, or None.
        A forced run is draftable with certainty: no other token can ever
        be accepted from this state."""
        self._lift(state)
        return self._forced[state]

    def mask(self, state: int, eos_bits: np.ndarray | None = None) -> np.ndarray:
        """Packed legal-token bitset for ``state``. ``eos_bits`` (packed,
        same width) is OR-ed in at terminal states — non-terminal states
        keep EOS masked so streams cannot stop mid-structure."""
        self._lift(state)
        base = self._base_masks[state]
        if eos_bits is not None and self._dfa.accepting(state):
            return base | eos_bits
        return base

    def states_visited(self) -> int:
        return len(self._token_trans)


class GrammarCompiler:
    """Schema-hash-keyed cache of CompiledGrammar instances over one
    vocabulary. One per engine; compile() is thread-safe and cheap on a
    cache hit (the common case — structured traffic shares schemas)."""

    def __init__(self, vocab: dict[int, bytes], vocab_size: int):
        self.vocab = vocab
        self.vocab_size = vocab_size
        self._lock = threading.Lock()
        self._cache: dict[str, CompiledGrammar] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def spec_hash(rf: dict) -> str:
        return hashlib.sha256(
            json.dumps(rf, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()

    def compile(self, rf: dict) -> CompiledGrammar | None:
        """response_format dict → CompiledGrammar (None = unconstrained).
        Raises GrammarError on malformed specs."""
        regex = compile_response_format_regex(rf)
        if regex is None:
            return None
        key = self.spec_hash(rf)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self.hits += 1
                return hit
        compiled = CompiledGrammar(regex, self.vocab, self.vocab_size, key)
        with self._lock:
            # racing compiles of the same schema: first one in wins, the
            # duplicate is discarded (both are equivalent).
            hit = self._cache.setdefault(key, compiled)
            if hit is compiled:
                self.misses += 1
            else:
                self.hits += 1
            return hit


def build_compiler(tokenizer_spec: dict | None, vocab_size: int) -> GrammarCompiler:
    """Engine-side factory: tokenizer spec dict (model card format;
    None → byte tokenizer) → GrammarCompiler over that vocabulary,
    packed to the MODEL's vocab_size (ids past the tokenizer's range are
    permanently illegal under any grammar — constrained output is always
    detokenizable)."""
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    tok = load_tokenizer(tokenizer_spec or {"type": "byte"})
    return GrammarCompiler(grammar_vocab(tok), vocab_size)
