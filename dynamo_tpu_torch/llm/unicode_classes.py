"""Unicode character classes for the standard library's ``re``.

Published ``tokenizer.json`` pre-tokenizers split text with Oniguruma
patterns such as Llama-3's ``[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}|…``.
``re`` has no ``\\p{..}``, and its ``\\s`` is not Oniguruma's, so
``translate`` rewrites such a pattern into one ``re`` compiles: every
``\\p{X}`` / ``\\P{X}``, ``\\s`` / ``\\S`` and ``\\d`` / ``\\D`` becomes an
explicit class of code-point ranges, inside brackets or out.

The classes come from ``unicodedata`` (built once, lazily, cached for the
process), with two corrections that make them the ``tokenizers`` library's:

- ``\\s`` is Unicode White_Space (25 code points). ``str.isspace`` also
  holds U+001C–U+001F, which Oniguruma's ``\\s`` does not.
- Letters and numbers assigned after the Unicode version of this
  interpreter's ``unicodedata`` (15.0 in Python 3.12) and before the one
  of Oniguruma in ``tokenizers`` 0.22 (16.0) are added to ``L`` and ``N``:
  ``_NEWER_L`` / ``_NEWER_N``, read off that library's classes. Their
  two-letter categories (``Lu``, ``Nd`` …) are not added.

Script classes (``\\p{Han}``…) and ``\\w`` / ``\\b`` are not derivable
from ``unicodedata`` the way Oniguruma defines them; ``translate`` raises
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import functools
import sys
import unicodedata

# Unicode White_Space: Oniguruma's \s.
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))

# Letters (L) and numbers (N) of Unicode 15.1 and 16.0 that Python 3.12's
# unicodedata (15.0) leaves unassigned.
_NEWER_L = ((0x01C89, 0x01C8A), (0x0A7CB, 0x0A7CD), (0x0A7DA, 0x0A7DC), (0x105C0, 0x105F3),
            (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
            (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
            (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
            (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
            (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_NEWER_N = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
            (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))

_MAX = sys.maxunicode

Ranges = tuple[tuple[int, int], ...]


@functools.cache
def _category_table() -> dict[str, Ranges]:
    """Two-letter general category → its code-point ranges (one pass over
    every code point, about a third of a second)."""
    out: dict[str, list[list[int]]] = {}
    cat = unicodedata.category
    prev, start = cat("\0"), 0
    for cp in range(1, _MAX + 2):
        c = cat(chr(cp)) if cp <= _MAX else None
        if c != prev:
            out.setdefault(prev, []).append([start, cp - 1])
            prev, start = c, cp
    return {k: tuple((a, b) for a, b in v) for k, v in out.items()}


def _merge(ranges) -> Ranges:
    out: list[list[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple((a, b) for a, b in out)


def _complement(ranges: Ranges) -> Ranges:
    out, nxt = [], 0
    for a, b in ranges:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= _MAX:
        out.append((nxt, _MAX))
    return tuple(out)


@functools.cache
def class_ranges(name: str) -> Ranges:
    """Code-point ranges of a general category (``L``, ``Lu``, ``N``,
    ``Nd``, ``P`` …) or of ``White_Space``."""
    if name == "White_Space":
        return _WHITE_SPACE
    table = _category_table()
    if len(name) == 2 and name in table:
        return table[name]
    if len(name) == 1 and any(k[0] == name for k in table):
        extra = {"L": _NEWER_L, "N": _NEWER_N}.get(name, ())
        return _merge([r for k, v in table.items() if k[0] == name for r in v] + list(extra))
    raise NotImplementedError(f"Unicode class \\p{{{name}}} has no unicodedata equivalent")


def _class_body(ranges: Ranges) -> str:
    """Ranges → the inside of a ``re`` bracket, as \\U escapes."""
    parts = []
    for a, b in ranges:
        parts.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
    return "".join(parts)


def _escape_ranges(letter: str, name: str | None) -> Ranges:
    """The ranges an escape stands for (\\s \\S \\d \\D \\p{..} \\P{..})."""
    if letter in "sS":
        r = class_ranges("White_Space")
    elif letter in "dD":
        r = class_ranges("Nd")
    else:
        r = class_ranges(name)
    return _complement(r) if letter in "SDP" else r


def translate(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json ``Split`` → a pattern for
    ``re`` that matches the same strings (leftmost-first alternation and
    backtracking are the same in both engines)."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.index("}", i + 3)
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2], i + 3
                if name.startswith("^"):
                    name, e = name[1:], "p" if e == "P" else "P"
                body = _class_body(_escape_ranges(e, name))
            elif e in "sSdD":
                body, i = _class_body(_escape_ranges(e, None)), i + 2
            elif e in "wWbBhHXRKG":
                raise NotImplementedError(f"pattern escape \\{e} has no re equivalent here")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            out.append(body if in_class else f"[{body}]")
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[" or pattern.startswith("&&", i):
                raise NotImplementedError("nested or intersected character classes")
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            if pattern.startswith("[^", i):
                out.append("[^")
                i += 2
            else:
                out.append("[")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ] is literal
                out.append("\\]")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)
