"""A renderer of the jinja2 subset that chat templates use.

The JAX package renders chat templates with jinja2, which the machines
this port targets do not carry. This module renders the same templates
for the constructs below, with jinja2's output for each, and refuses
anything else with :class:`UnsupportedTemplateError` when the template
is built, never with a wrongly rendered prompt:

- text, ``{{ expr }}`` and ``{# comments #}``, with ``{%-`` / ``-%}``
  (and ``{{-`` / ``-}}``, ``+``) whitespace control, ``trim_blocks``,
  ``lstrip_blocks`` and the dropped trailing newline, as jinja2's lexer
  does them;
- ``{% for x in expr %}`` with ``loop.index0`` / ``index`` / ``first`` /
  ``last`` / ``length`` / ``revindex`` / ``revindex0``; ``{% if %}`` /
  ``elif`` / ``else``; ``{% set name = expr %}`` (loop bodies are their
  own scope, as in jinja2);
- attribute and item access (jinja2's getattr-then-item and
  item-then-getattr rules), string / int / bool / none literals,
  parentheses, calls of global functions with positional arguments;
- ``+``, ``~``, ``==``, ``!=``, ``<``, ``>``, ``<=``, ``>=``, ``in``,
  ``not in``, ``and``, ``or``, ``not``, ``is [not] defined`` and
  ``is [not] none``;
- the filters ``trim``, ``length``, ``tojson``, ``upper`` and ``lower``,
  without arguments.

Undefined values are strict (jinja2's ``StrictUndefined``): rendering,
testing, comparing or iterating one raises :class:`UndefinedError`. The
module mirrors the part of jinja2's API that ``ChatTemplate`` calls
(``Environment(...).from_string(src).render(**vars)``, ``globals``,
``StrictUndefined``, ``UndefinedError``, ``BaseLoader``), so the
preprocessor reads as it does in the JAX package.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable

__all__ = [
    "BaseLoader", "Environment", "StrictUndefined", "Template", "TemplateError",
    "TemplateSyntaxError", "UndefinedError", "UnsupportedTemplateError",
]


class TemplateError(Exception):
    """Base of every error this module raises."""


class TemplateSyntaxError(TemplateError):
    """The template source does not parse."""


class UnsupportedTemplateError(TemplateSyntaxError):
    """The template uses a construct outside the supported subset."""


class UndefinedError(TemplateError):
    """An undefined value was used (rendered, tested, compared...)."""


class BaseLoader:
    """Stand-in for jinja2's loader argument: templates come from strings."""


class StrictUndefined:
    """An undefined name or attribute: any use but ``is defined`` raises."""

    __slots__ = ("_name",)

    def __init__(self, name: Any = None):
        object.__setattr__(self, "_name", name)

    def _fail(self, *args, **kwargs):
        raise UndefinedError(f"{self._name!r} is undefined")

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        self._fail()

    __str__ = __bool__ = __iter__ = __len__ = __eq__ = __ne__ = __hash__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __contains__ = __getitem__ = __call__ = _fail
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __mod__ = __rmod__ = __neg__ = __pos__ = _fail
    __int__ = __float__ = _fail


# -- lexer ----------------------------------------------------------------------

_BEGIN = re.compile(r"\{([{%#])([-+]?)")
_WS = re.compile(r"\s+")
_TOKEN = re.compile(
    r"""(?P<ws>\s+)
      | (?P<float>(?<!\.)\d[\d_]*(?:\.\d[\d_]*)?[eE][+\-]?\d[\d_]*|(?<!\.)\d[\d_]*\.\d[\d_]*)
      | (?P<int>\d[\d_]*)
      | (?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
      | (?P<string>'([^'\\]*(?:\\.[^'\\]*)*)'|"([^"\\]*(?:\\.[^"\\]*)*)")
      | (?P<op>//|\*\*|==|!=|<=|>=|[+\-/*%~\[\](){}=.:|,;<>])""",
    re.S | re.X,
)


def _unescape(raw: str) -> str:
    return raw.encode("ascii", "backslashreplace").decode("unicode-escape")


def _tag_tokens(src: str, pos: int, closer: str, trim: bool):
    """Tokens of one ``{% %}`` or ``{{ }}`` tag from ``pos`` to its end
    delimiter ``closer`` ("%}" or "}}") → (tokens, position after the
    end and the whitespace it consumes)."""
    toks: list[tuple[str, Any]] = []
    depth = 0
    n = len(src)
    while True:
        if pos >= n:
            raise TemplateSyntaxError(f"unexpected end of template, expected {closer!r}")
        if depth == 0:
            if src.startswith("+" + closer, pos):
                return toks, pos + 3
            if src.startswith("-" + closer, pos):
                m = _WS.match(src, pos + 3)
                return toks, (m.end() if m else pos + 3)
            if src.startswith(closer, pos):
                end = pos + 2
                if trim and closer == "%}" and src.startswith("\n", end):
                    end += 1
                return toks, end
        m = _TOKEN.match(src, pos)
        if m is None:
            raise TemplateSyntaxError(f"unexpected character {src[pos]!r}")
        kind = m.lastgroup
        if kind == "string":
            toks.append(("string", _unescape(m.group()[1:-1].replace("\r\n", "\n"))))
        elif kind == "int":
            toks.append(("int", int(m.group().replace("_", ""))))
        elif kind == "float":
            toks.append(("float", m.group()))
        elif kind == "name":
            toks.append(("name", m.group()))
        elif kind == "op":
            op = m.group()
            if op in "([{":
                depth += 1
            elif op in ")]}":
                depth = max(0, depth - 1)
            toks.append(("op", op))
        pos = m.end()


def _lex(source: str, trim_blocks: bool, lstrip_blocks: bool) -> list[tuple[str, Any]]:
    """Template source → [("data", text) | ("var", tokens) | ("block",
    tokens)], with jinja2's whitespace rules applied to the data."""
    source = source.replace("\r\n", "\n").replace("\r", "\n")
    if source.endswith("\n"):  # keep_trailing_newline=False
        source = source[:-1]
    out: list[tuple[str, Any]] = []
    pos = 0
    line_starting = True  # the last consumed character ended a line
    while True:
        m = _BEGIN.search(source, pos)
        if m is None:
            if pos < len(source):
                out.append(("data", source[pos:]))
            return out
        text = source[pos:m.start()]
        kind, sign = m.group(1), m.group(2)
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and lstrip_blocks and kind != "{":
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and _WS.fullmatch(text, l_pos):
                text = text[:l_pos]
        if text:
            out.append(("data", text))
        if kind == "#":
            end_re = re.compile(r"\+#\}|-#\}\s*|#\}" + ("\n?" if trim_blocks else ""))
            e = end_re.search(source, m.end())
            if e is None:
                raise TemplateSyntaxError("unclosed comment")
            pos = e.end()
        else:
            toks, pos = _tag_tokens(source, m.end(), "}}" if kind == "{" else "%}", trim_blocks)
            out.append(("var" if kind == "{" else "block", toks))
        line_starting = source[pos - 1 : pos] == "\n"


# -- parser ---------------------------------------------------------------------

_LOOP_ATTRS = {"index0", "index", "first", "last", "length", "revindex", "revindex0"}
_FILTERS: dict[str, Callable[[Any], Any]] = {}
_COMPARE = {"==", "!=", "<", ">", "<=", ">="}


def _unsupported(what: str):
    raise UnsupportedTemplateError(f"template construct not supported: {what}")


class _Parser:
    def __init__(self, tokens: list[tuple[str, Any]]):
        self.toks = tokens
        self.i = 0

    # token stream
    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("end", None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        t = self.peek(k)
        return t[0] == kind and (value is None or t[1] == value)

    def expect(self, kind: str, value=None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise TemplateSyntaxError(f"expected {value or kind}, got {t[1]!r}")
        return t

    def done(self) -> None:
        if self.i != len(self.toks):
            t = self.peek()
            if t[0] == "name" and t[1] == "if":
                _unsupported("inline if expression")
            if t[0] == "op" and t[1] == ",":
                _unsupported("tuples")
            raise TemplateSyntaxError(f"unexpected {t[1]!r}")

    # expressions, in jinja2's precedence
    def expr(self):
        return self.or_()

    def or_(self):
        node = self.and_()
        while self.at("name", "or"):
            self.next()
            node = ("or", node, self.and_())
        return node

    def and_(self):
        node = self.not_()
        while self.at("name", "and"):
            self.next()
            node = ("and", node, self.not_())
        return node

    def not_(self):
        if self.at("name", "not"):
            self.next()
            return ("not", self.not_())
        return self.compare()

    def compare(self):
        first = self.math1()
        ops = []
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in _COMPARE:
                self.next()
                ops.append((t[1], self.math1()))
            elif self.at("name", "in"):
                self.next()
                ops.append(("in", self.math1()))
            elif self.at("name", "not") and self.at("name", "in", 1):
                self.next()
                self.next()
                ops.append(("notin", self.math1()))
            else:
                break
        return ("compare", first, ops) if ops else first

    def math1(self):
        node = self.concat()
        while self.at("op", "+") or self.at("op", "-"):
            if self.next()[1] == "-":
                _unsupported("'-' operator")
            node = ("add", node, self.concat())
        return node

    def concat(self):
        parts = [self.math2()]
        while self.at("op", "~"):
            self.next()
            parts.append(self.math2())
        return ("concat", parts) if len(parts) > 1 else parts[0]

    def math2(self):
        node = self.unary()
        t = self.peek()
        if t[0] == "op" and t[1] in ("*", "/", "//", "%", "**"):
            _unsupported(f"{t[1]!r} operator")
        return node

    def unary(self):
        if self.at("op", "-") or self.at("op", "+"):
            _unsupported("unary sign")
        node = self.postfix(self.primary())
        return self.filters(node)

    def primary(self):
        kind, value = self.next()
        if kind == "name":
            if value in ("true", "True"):
                return ("const", True)
            if value in ("false", "False"):
                return ("const", False)
            if value in ("none", "None"):
                return ("const", None)
            return ("name", value)
        if kind == "string":
            s = value
            while self.at("string"):  # adjacent literals concatenate
                s += self.next()[1]
            return ("const", s)
        if kind == "int":
            return ("const", value)
        if kind == "float":
            _unsupported("float literals")
        if kind == "op" and value == "(":
            node = self.expr()
            if self.at("op", ","):
                _unsupported("tuples")
            self.expect("op", ")")
            return node
        if kind == "op" and value in ("[", "{"):
            _unsupported("list and dict literals")
        raise TemplateSyntaxError(f"unexpected {value!r}")

    def postfix(self, node):
        while True:
            if self.at("op", "."):
                self.next()
                kind, attr = self.next()
                if kind != "name":
                    _unsupported("attribute access by number")
                if node == ("name", "loop") and attr not in _LOOP_ATTRS:
                    _unsupported(f"loop.{attr}")
                node = ("getattr", node, attr)
            elif self.at("op", "["):
                self.next()
                if self.at("op", ":"):
                    _unsupported("slices")
                key = self.expr()
                if self.at("op", ":") or self.at("op", ","):
                    _unsupported("slices")
                self.expect("op", "]")
                node = ("getitem", node, key)
            elif self.at("op", "("):
                if node[0] != "name":
                    _unsupported("method calls")
                node = ("call", node[1], self.call_args())
            else:
                return node

    def call_args(self):
        self.expect("op", "(")
        args = []
        while not self.at("op", ")"):
            if self.at("name") and self.at("op", "=", 1):
                _unsupported("keyword arguments")
            if self.at("op", "*") or self.at("op", "**"):
                _unsupported("star arguments")
            args.append(self.expr())
            if not self.at("op", ")"):
                self.expect("op", ",")
        self.next()
        return args

    def filters(self, node):
        while True:
            if self.at("op", "|"):
                self.next()
                name = self.expect("name")[1]
                if name not in _FILTERS:
                    _unsupported(f"filter {name!r}")
                if self.at("op", "("):
                    _unsupported(f"arguments to filter {name!r}")
                node = ("filter", name, node)
            elif self.at("name", "is"):
                self.next()
                negate = False
                if self.at("name", "not"):
                    self.next()
                    negate = True
                name = self.expect("name")[1]
                if name not in ("defined", "none"):
                    _unsupported(f"test {name!r}")
                t = self.peek()
                if (t[0] in ("name", "string", "int", "float") or (t[0] == "op" and t[1] in "([{")) \
                        and not (t[0] == "name" and t[1] in ("else", "or", "and")):
                    _unsupported(f"arguments to test {name!r}")
                node = ("test", name, node, negate)
            elif self.at("op", "("):
                _unsupported("calling a filtered value")
            else:
                return node


def _parse(items: list[tuple[str, Any]]) -> list:
    """Lexed items → a node tree: ("text", s) | ("out", expr) |
    ("for", name, expr, body) | ("if", [(cond, body)...], else_body) |
    ("set", name, expr)."""
    pos = 0

    def block_head(toks):
        if not toks or toks[0][0] != "name":
            raise TemplateSyntaxError("empty or malformed block tag")
        return toks[0][1]

    def parse_body(enders: tuple[str, ...]):
        nonlocal pos
        body = []
        while pos < len(items):
            kind, val = items[pos]
            if kind == "data":
                body.append(("text", val))
                pos += 1
            elif kind == "var":
                p = _Parser(val)
                e = p.expr()
                p.done()
                body.append(("out", e))
                pos += 1
            else:
                head = block_head(val)
                if head in enders:
                    return body, head, val
                pos += 1
                if head == "for":
                    body.append(parse_for(val))
                elif head == "if":
                    body.append(parse_if(val))
                elif head == "set":
                    body.append(parse_set(val))
                elif head in ("endfor", "endif", "elif", "else"):
                    raise TemplateSyntaxError(f"unexpected {head!r}")
                else:
                    _unsupported(f"{{% {head} %}}")
        if enders:
            raise TemplateSyntaxError(f"missing {' or '.join(enders)!r}")
        return body, None, None

    def parse_for(toks):
        nonlocal pos
        p = _Parser(toks[1:])
        target = p.expect("name")[1]
        if p.at("op", ","):
            _unsupported("tuple unpacking in for")
        p.expect("name", "in")
        it = p.expr()
        if p.at("name", "if") or p.at("name", "recursive"):
            _unsupported(f"for ... {p.peek()[1]}")
        p.done()
        body, head, _ = parse_body(("endfor", "else"))
        if head == "else":
            _unsupported("for ... else")
        pos += 1
        return ("for", target, it, body)

    def parse_if(toks):
        nonlocal pos
        branches = []
        cond_toks = toks[1:]
        while True:
            p = _Parser(cond_toks)
            cond = p.expr()
            p.done()
            body, head, val = parse_body(("elif", "else", "endif"))
            pos += 1
            branches.append((cond, body))
            if head == "elif":
                cond_toks = val[1:]
                continue
            orelse = []
            if head == "else":
                if len(val) > 1:
                    raise TemplateSyntaxError("unexpected tokens after else")
                orelse, _head, _ = parse_body(("endif",))
                pos += 1
            return ("if", branches, orelse)

    def parse_set(toks):
        p = _Parser(toks[1:])
        if not p.at("name") or not p.at("op", "=", 1):
            _unsupported("set other than 'set name = expr'")
        name = p.next()[1]
        p.next()
        e = p.expr()
        p.done()
        return ("set", name, e)

    body, _, _ = parse_body(())
    return body


# -- evaluation -----------------------------------------------------------------


def _soft_str(v) -> str:
    return v if isinstance(v, str) else str(v)


def _tojson(v) -> str:
    return (json.dumps(v, sort_keys=True).replace("<", "\\u003c").replace(">", "\\u003e")
            .replace("&", "\\u0026").replace("'", "\\u0027"))


_FILTERS.update({
    "trim": lambda v: _soft_str(v).strip(),
    "length": len,
    "tojson": _tojson,
    "upper": lambda v: _soft_str(v).upper(),
    "lower": lambda v: _soft_str(v).lower(),
})


class _Loop:
    __slots__ = ("index0", "length")

    def __init__(self, length: int):
        self.index0 = 0
        self.length = length

    @property
    def index(self) -> int:
        return self.index0 + 1

    @property
    def first(self) -> bool:
        return self.index0 == 0

    @property
    def last(self) -> bool:
        return self.index0 == self.length - 1

    @property
    def revindex(self) -> int:
        return self.length - self.index0

    @property
    def revindex0(self) -> int:
        return self.length - self.index0 - 1


def _getattr(obj, attr: str):
    if isinstance(obj, StrictUndefined):
        obj._fail()
    try:
        return getattr(obj, attr)
    except AttributeError:
        pass
    try:
        return obj[attr]
    except (TypeError, LookupError, AttributeError):
        return StrictUndefined(attr)


def _getitem(obj, key):
    if isinstance(obj, StrictUndefined):
        obj._fail()
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return StrictUndefined(key)


_CMP: dict[str, Callable[[Any, Any], Any]] = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
    ">": lambda a, b: a > b, "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}


class _Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: "_Scope | None", init: dict | None = None):
        self.vars = dict(init or {})
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return StrictUndefined(name)


def _eval(node, scope: _Scope):
    op = node[0]
    if op == "const":
        return node[1]
    if op == "name":
        return scope.lookup(node[1])
    if op == "getattr":
        return _getattr(_eval(node[1], scope), node[2])
    if op == "getitem":
        return _getitem(_eval(node[1], scope), _eval(node[2], scope))
    if op == "and":
        return _eval(node[1], scope) and _eval(node[2], scope)
    if op == "or":
        return _eval(node[1], scope) or _eval(node[2], scope)
    if op == "not":
        return not _eval(node[1], scope)
    if op == "compare":
        left = _eval(node[1], scope)
        for cmp, rnode in node[2]:
            right = _eval(rnode, scope)
            if not _CMP[cmp](left, right):
                return False
            left = right
        return True
    if op == "add":
        return _eval(node[1], scope) + _eval(node[2], scope)
    if op == "concat":
        return "".join(_soft_str(_eval(n, scope)) for n in node[1])
    if op == "filter":
        return _FILTERS[node[1]](_eval(node[2], scope))
    if op == "test":
        v = _eval(node[2], scope)
        r = (not isinstance(v, StrictUndefined)) if node[1] == "defined" else v is None
        return r != node[3]
    if op == "call":
        fn = scope.lookup(node[1])
        return fn(*[_eval(a, scope) for a in node[2]])
    raise AssertionError(op)


def _exec(body: list, scope: _Scope, out: list[str]) -> None:
    for node in body:
        op = node[0]
        if op == "text":
            out.append(node[1])
        elif op == "out":
            out.append(_soft_str(_eval(node[1], scope)))
        elif op == "set":
            scope.vars[node[1]] = _eval(node[2], scope)
        elif op == "if":
            for cond, branch in node[1]:
                if _eval(cond, scope):
                    _exec(branch, scope, out)
                    break
            else:
                _exec(node[2], scope, out)
        elif op == "for":
            items = list(_eval(node[2], scope))
            loop = _Loop(len(items))
            for i, item in enumerate(items):
                # Each iteration is a fresh scope: a `set` in the body is
                # seen by the rest of that iteration only (jinja2's rule).
                loop.index0 = i
                _exec(node[3], _Scope(scope, {"loop": loop, node[1]: item}), out)


class Template:
    def __init__(self, body: list, globals_: dict[str, Any]):
        self._body = body
        self._globals = globals_

    def render(self, *args, **kwargs) -> str:
        ctx = dict(*args, **kwargs)
        scope = _Scope(_Scope(None, self._globals), ctx)
        out: list[str] = []
        _exec(self._body, scope, out)
        return "".join(out)


class Environment:
    """The jinja2 ``Environment`` surface ChatTemplate uses."""

    def __init__(self, loader: BaseLoader | None = None, autoescape: bool = False,
                 undefined: type = StrictUndefined, trim_blocks: bool = False,
                 lstrip_blocks: bool = False):
        if autoescape:
            raise UnsupportedTemplateError("autoescape is not supported")
        if undefined is not StrictUndefined:
            raise UnsupportedTemplateError("only StrictUndefined is supported")
        self.trim_blocks = trim_blocks
        self.lstrip_blocks = lstrip_blocks
        self.globals: dict[str, Any] = {}

    def from_string(self, source: str) -> Template:
        """Parse ``source`` → Template; raises TemplateSyntaxError (or its
        subclass UnsupportedTemplateError) here, before any render."""
        body = _parse(_lex(source, self.trim_blocks, self.lstrip_blocks))
        return Template(body, self.globals)
