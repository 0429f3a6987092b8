"""A pure-Python reader and writer for the YAML that graph documents and
Kubernetes manifests use.

The JAX operator reads graph files and renders manifests with PyYAML,
which the card's machine does not carry. This module covers the subset
those documents are written in, with PyYAML's ``safe_load`` meaning:

- block mappings and block sequences (a sequence may sit at its key's
  indent, and a sequence item may open a mapping on its own line);
- flow mappings and sequences on one line (``{a: 1}``, ``[x, "y"]``);
- plain scalars resolved as YAML 1.1 resolves them (null, booleans
  including yes/no/on/off, decimal, octal, hex and binary ints, floats
  with a dot, .inf and .nan), single- and double-quoted scalars with
  their escapes;
- ``#`` comments and ``---`` document separators.

Anything else (block scalars ``|`` and ``>``, anchors, aliases, tags,
directives, complex keys, merge keys, timestamps, sexagesimal numbers,
scalars or flow collections over several lines) raises
:class:`YamlLiteError` naming the construct, rather than reading it
some other way.

:func:`dump` writes block style that PyYAML's ``safe_load`` reads back
equal: mappings in insertion order, strings plain where that reads back
as the same string and double-quoted otherwise.
"""

from __future__ import annotations

import json
import math
import re

__all__ = ["YamlLiteError", "load", "load_all", "dump", "dump_all"]


class YamlLiteError(ValueError):
    """A document outside the supported subset, or malformed."""


# -- scalars ------------------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:$|[Tt \t])")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _resolve_plain(text: str, where: str):
    """A plain scalar → its value under YAML 1.1's implicit types."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text == "<<":
        raise YamlLiteError(f"{where}: merge keys (<<) are not supported")
    if text == "=":
        raise YamlLiteError(f"{where}: the value key (=) is not supported")
    if _TIMESTAMP.match(text):
        raise YamlLiteError(f"{where}: timestamps are not supported ({text!r})")
    if _SEXAGESIMAL.fullmatch(text):
        raise YamlLiteError(f"{where}: sexagesimal numbers are not supported ({text!r})")
    if _INT.fullmatch(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s != "0" and s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    return text


def _single_quoted(text: str, i: int, where: str) -> tuple[str, int]:
    """``text[i] == "'"`` → (the scalar, index after its closing quote)."""
    out = []
    j = i + 1
    while True:
        k = text.find("'", j)
        if k < 0:
            raise YamlLiteError(f"{where}: quoted scalars over several lines are not supported")
        out.append(text[j:k])
        if text.startswith("''", k):
            out.append("'")
            j = k + 2
            continue
        return "".join(out), k + 1


def _double_quoted(text: str, i: int, where: str) -> tuple[str, int]:
    """``text[i] == '"'`` → (the scalar, index after its closing quote)."""
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == '"':
            return "".join(out), j + 1
        if c != "\\":
            out.append(c)
            j += 1
            continue
        if j + 1 >= len(text):
            break
        e = text[j + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            j += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            digits = text[j + 2:j + 2 + n]
            if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                raise YamlLiteError(f"{where}: bad escape \\{e}{digits}")
            out.append(chr(int(digits, 16)))
            j += 2 + n
        else:
            raise YamlLiteError(f"{where}: unknown escape \\{e}")
    raise YamlLiteError(f"{where}: quoted scalars over several lines are not supported")


_INDICATORS = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
               ">": "block scalars", "%": "directives", "@": "reserved indicators",
               "`": "reserved indicators", "?": "complex keys"}


def _refuse_indicator(text: str, where: str) -> None:
    c = text[:1]
    if c in _INDICATORS and (c not in "?" or text[1:2] in ("", " ")):
        raise YamlLiteError(f"{where}: {_INDICATORS[c]} ({c}) are not supported")


# -- flow collections ---------------------------------------------------------


class _Flow:
    """A flow collection or scalar on one line, from position ``i``."""

    def __init__(self, text: str, where: str):
        self.text, self.where = text, where

    def _skip(self, i: int) -> int:
        while i < len(self.text) and self.text[i] == " ":
            i += 1
        return i

    def value(self, i: int) -> tuple[object, int]:
        t = self.text
        i = self._skip(i)
        if i >= len(t):
            raise YamlLiteError(f"{self.where}: flow collections over several lines are "
                                "not supported")
        c = t[i]
        if c == "[":
            return self._seq(i + 1)
        if c == "{":
            return self._map(i + 1)
        if c == "'":
            return _single_quoted(t, i, self.where)
        if c == '"':
            return _double_quoted(t, i, self.where)
        _refuse_indicator(t[i:], self.where)
        j = i
        while j < len(t) and t[j] not in ",[]{}":
            if t[j] == ":" and (j + 1 == len(t) or t[j + 1] in " ,]}"):
                break
            j += 1
        return _resolve_plain(t[i:j].rstrip(), self.where), j

    def _seq(self, i: int) -> tuple[list, int]:
        out = []
        while True:
            i = self._skip(i)
            if i < len(self.text) and self.text[i] == "]":
                return out, i + 1
            v, i = self.value(i)
            i = self._skip(i)
            if i < len(self.text) and self.text[i] == ":":
                raise YamlLiteError(f"{self.where}: single-pair mappings in a flow "
                                    "sequence are not supported")
            out.append(v)
            i = self._after_item(i, "]")

    def _map(self, i: int) -> tuple[dict, int]:
        out = {}
        while True:
            i = self._skip(i)
            if i < len(self.text) and self.text[i] == "}":
                return out, i + 1
            k, i = self.value(i)
            i = self._skip(i)
            if i >= len(self.text) or self.text[i] != ":":
                raise YamlLiteError(f"{self.where}: flow mapping entries without a value "
                                    "are not supported")
            _hashable(k, self.where)
            v, i = self.value(i + 1)
            out[k] = v
            i = self._after_item(i, "}")

    def _after_item(self, i: int, close: str) -> int:
        i = self._skip(i)
        if i >= len(self.text):
            raise YamlLiteError(f"{self.where}: flow collections over several lines are "
                                "not supported")
        if self.text[i] == ",":
            return i + 1
        if self.text[i] == close:
            return i
        raise YamlLiteError(f"{self.where}: expected ',' or {close!r} at column {i + 1}")


def _hashable(key, where: str) -> None:
    if isinstance(key, (list, dict)):
        raise YamlLiteError(f"{where}: collection keys are not supported")


def _inline(text: str, where: str):
    """A value written after ``key:`` or ``- `` on its line."""
    f = _Flow(text, where)
    if text[0] in "[{'\"":
        v, end = f.value(0)
        if text[end:].strip():
            raise YamlLiteError(f"{where}: unexpected {text[end:].strip()!r} after a value")
        return v
    _refuse_indicator(text, where)
    return _resolve_plain(text, where)


# -- lines --------------------------------------------------------------------


def _strip_comment(line: str, where: str) -> str:
    """Drop a ``#`` comment (one at the line's start or after a space,
    outside quotes)."""
    quote = None
    prev = " "
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line.startswith("''", i):
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c in "'\"" and prev in " -:[{,":
            quote = c
        elif c == "#" and prev in " \t":
            return line[:i].rstrip()
        prev = c
        i += 1
    if quote is not None:
        raise YamlLiteError(f"{where}: quoted scalars over several lines are not supported")
    return line.rstrip()


def _key_split(content: str, where: str) -> tuple[object, str] | None:
    """``key: rest`` → (key, rest); None when the line is no mapping entry."""
    if content[0] in "'\"":
        quoted = _single_quoted if content[0] == "'" else _double_quoted
        key, j = quoted(content, 0, where)
        rest = content[j:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if content[0] in "[{":
        return None
    j = 0
    while True:
        j = content.find(":", j)
        if j < 0:
            return None
        if j + 1 == len(content) or content[j + 1] == " ":
            break
        j += 1
    raw = content[:j].rstrip()
    if not raw:
        raise YamlLiteError(f"{where}: an empty key is not supported")
    _refuse_indicator(raw, where)
    key = _resolve_plain(raw, where)
    _hashable(key, where)
    return key, content[j + 1:].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Doc:
    def __init__(self, lines: list[tuple[int, str, int]]):
        self.lines = lines  # (indent, content, line number)

    def where(self, i: int) -> str:
        return f"line {self.lines[i][2]}" if i < len(self.lines) else "end of document"

    def block(self, i: int, indent: int):
        ind, content, _ = self.lines[i]
        if _is_item(content):
            return self.seq(i, ind)
        if _key_split(content, self.where(i)) is not None:
            return self.mapping(i, ind)
        value = _inline(content, self.where(i))
        if i + 1 < len(self.lines) and self.lines[i + 1][0] > indent:
            raise YamlLiteError(f"{self.where(i + 1)}: plain scalars over several lines are "
                                "not supported")
        return value, i + 1

    def _value_after(self, i: int, indent: int, rest: str, seq_here: bool):
        """The value of a key or item on line i: inline, the block that
        follows it, or null."""
        where = self.where(i)
        if rest:
            v = _inline(rest, where)
            if i + 1 < len(self.lines) and self.lines[i + 1][0] > indent:
                raise YamlLiteError(f"{self.where(i + 1)}: plain scalars over several lines "
                                    "are not supported")
            return v, i + 1
        if i + 1 < len(self.lines):
            nind, ncontent, _ = self.lines[i + 1]
            if nind > indent:
                return self.block(i + 1, nind)
            if seq_here and nind == indent and _is_item(ncontent):
                return self.seq(i + 1, indent)
        return None, i + 1

    def mapping(self, i: int, indent: int):
        out: dict = {}
        while i < len(self.lines):
            ind, content, _ = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlLiteError(f"{self.where(i)}: unexpected indentation")
            kv = _key_split(content, self.where(i))
            if kv is None:
                if _is_item(content):
                    raise YamlLiteError(f"{self.where(i)}: a sequence item where a mapping "
                                        "key was expected")
                raise YamlLiteError(f"{self.where(i)}: expected 'key: value', got "
                                    f"{content!r}")
            key, rest = kv
            out[key], i = self._value_after(i, indent, rest, seq_here=True)
        return out, i

    def seq(self, i: int, indent: int):
        out = []
        while i < len(self.lines):
            ind, content, lineno = self.lines[i]
            if ind < indent or (ind == indent and not _is_item(content)):
                break
            if ind > indent:
                raise YamlLiteError(f"{self.where(i)}: unexpected indentation")
            rest = content[1:].lstrip(" ")
            col = ind + len(content) - len(rest)
            if rest and (_is_item(rest) or _key_split(rest, self.where(i)) is not None):
                # "- key: v" / "- - x": the item is a block that starts here.
                self.lines[i] = (col, rest, lineno)
                v, i = self.block(i, col)
            else:
                v, i = self._value_after(i, indent, rest, seq_here=False)
            out.append(v)
        return out, i


def _documents(text: str) -> list[list[tuple[int, str, int]]]:
    docs: list[list] = [[]]
    started = False
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        body = raw.lstrip(" ")
        if body.startswith("\t") or (raw[:1] == "\t"):
            raise YamlLiteError(f"{where}: tab indentation is not supported")
        content = _strip_comment(body, where)
        if not content:
            continue
        indent = len(raw) - len(body)
        if indent == 0 and (content == "---" or content.startswith("--- ")):
            if started or docs[-1]:
                docs.append([])
            started = True
            content = content[3:].strip()
            if not content:
                continue
        elif indent == 0 and (content == "..." or content.startswith("... ")):
            raise YamlLiteError(f"{where}: the document end marker (...) is not supported")
        elif indent == 0 and content.startswith("%"):
            raise YamlLiteError(f"{where}: directives (%) are not supported")
        docs[-1].append((indent, content, n))
    return docs if started or docs[0] else []


def load_all(text: str) -> list:
    """Every document of ``text`` (PyYAML's ``safe_load_all``)."""
    out = []
    for lines in _documents(text):
        if not lines:
            out.append(None)
            continue
        doc = _Doc(lines)
        value, i = doc.block(0, lines[0][0])
        if i < len(lines):
            raise YamlLiteError(f"{doc.where(i)}: unexpected content after the document's "
                                "top-level node")
        out.append(value)
    return out


def load(text: str):
    """The one document of ``text`` (PyYAML's ``safe_load``): None when it
    holds none, an error when it holds more."""
    docs = load_all(text)
    if len(docs) > 1:
        raise YamlLiteError(f"expected a single document, found {len(docs)}")
    return docs[0] if docs else None


# -- writer -------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./:=+-]*|-[A-Za-z0-9_./][A-Za-z0-9_./:=+-]*")


def _scalar(v) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if (_PLAIN_SAFE.fullmatch(v) and not v.endswith(":")
                and isinstance(_safe_resolve(v), str)):
            return v
        return json.dumps(v, ensure_ascii=False)
    raise YamlLiteError(f"cannot write a {type(v).__name__}")


def _safe_resolve(v: str):
    try:
        return _resolve_plain(v, "dump")
    except YamlLiteError:
        return None  # a timestamp or the like: quote it


def _emit(v, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, (dict, list)) and x:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline_out(x)}")
    else:
        for x in v:
            if isinstance(x, (dict, list)) and x:
                sub: list[str] = []
                _emit(x, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline_out(x)}")


def _inline_out(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump(obj) -> str:
    """One document in block style, ending in a newline."""
    if isinstance(obj, (dict, list)) and obj:
        out: list[str] = []
        _emit(obj, 0, out)
        return "\n".join(out) + "\n"
    return _inline_out(obj) + "\n"


def dump_all(docs) -> str:
    """Several documents joined by ``---`` lines."""
    return "---\n".join(dump(d) for d in docs)
