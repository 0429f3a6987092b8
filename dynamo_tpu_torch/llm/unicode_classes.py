"""Unicode character classes for the standard library's ``re``, and the
``tokenizers`` library's character predicates.

Published ``tokenizer.json`` pre-tokenizers split text with Oniguruma
patterns such as Llama-3's ``[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}|…``.
``re`` has no ``\\p{..}``, and its ``\\s``, ``\\w`` and ``\\b`` are not
Oniguruma's, so ``translate`` rewrites such a pattern into one ``re``
compiles: every ``\\p{X}`` / ``\\P{X}``, ``\\s`` / ``\\S``, ``\\d`` / ``\\D``,
``\\w`` / ``\\W`` and ``\\h`` / ``\\H`` becomes an explicit class of
code-point ranges, inside brackets or out; ``\\b`` / ``\\B`` become
lookarounds over the translated ``\\w``; ``^`` / ``$`` are line anchors, as
in Oniguruma's Ruby syntax. ``onig_find_iter`` finds matches in
Oniguruma's order, which differs from ``re.finditer``'s after an empty
match.

The classes come from ``unicodedata`` (Unicode 15.0 in Python 3.12; built
once, lazily, cached for the process), corrected to the library's by the
tables of llm/unicode_tables.py, which are read off the library:

- ``\\p{..}`` general categories (short or long names) and ``\\w`` are
  Oniguruma's (Unicode 16.0); ``\\s`` is Unicode White_Space.
- ``\\p{<Script>}`` (long names or aliases) comes from llm/unicode_scripts.py.
- The predicates of the library's components (``predicate_ranges``):
  Rust's ``char::is_numeric`` and ``is_whitespace``, the punctuation of
  ``Punctuation`` / ``BertPreTokenizer``, ``BertNormalizer``'s control and
  Chinese characters, and ``StripAccents``' non-spacing marks.
- ``lowercase`` is ``Lowercase`` (Rust's ``char::to_lowercase`` character
  by character); ``normalize`` is the library's NFC/NFD/NFKC/NFKD, whose
  Unicode is older than ``unicodedata``'s.

Oniguruma properties other than categories, scripts, ``Any``, ``ASCII``,
``Word`` and ``White_Space``, and nested or intersected classes, raise
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import bisect
import functools
import re
import sys
import unicodedata

from dynamo_tpu_torch.llm import unicode_scripts, unicode_tables

_MAX = sys.maxunicode

Ranges = tuple[tuple[int, int], ...]

_LONG_CATEGORIES = {
    "LETTER": "L", "CASEDLETTER": "LC", "UPPERCASELETTER": "Lu", "LOWERCASELETTER": "Ll",
    "TITLECASELETTER": "Lt", "MODIFIERLETTER": "Lm", "OTHERLETTER": "Lo", "MARK": "M",
    "COMBININGMARK": "M", "NONSPACINGMARK": "Mn", "SPACINGMARK": "Mc", "ENCLOSINGMARK": "Me",
    "NUMBER": "N", "DECIMALNUMBER": "Nd", "LETTERNUMBER": "Nl", "OTHERNUMBER": "No",
    "PUNCTUATION": "P", "CONNECTORPUNCTUATION": "Pc", "DASHPUNCTUATION": "Pd",
    "OPENPUNCTUATION": "Ps", "CLOSEPUNCTUATION": "Pe", "INITIALPUNCTUATION": "Pi",
    "FINALPUNCTUATION": "Pf", "OTHERPUNCTUATION": "Po", "SYMBOL": "S", "MATHSYMBOL": "Sm",
    "CURRENCYSYMBOL": "Sc", "MODIFIERSYMBOL": "Sk", "OTHERSYMBOL": "So", "SEPARATOR": "Z",
    "SPACESEPARATOR": "Zs", "LINESEPARATOR": "Zl", "PARAGRAPHSEPARATOR": "Zp", "OTHER": "C",
    "CONTROL": "Cc", "FORMAT": "Cf", "SURROGATE": "Cs", "PRIVATEUSE": "Co",
    "UNASSIGNED": "Cn"}
# Letters and numbers of Unicode 15.1 and 16.0 that Python 3.12's
# unicodedata (15.0) leaves unassigned.
_NEWER_L = unicode_tables.CATEGORIES["L"]["add"]
_NEWER_N = unicode_tables.CATEGORIES["N"]["add"]
_ASCII_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"


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


def _subtract(ranges: Ranges, remove: Ranges) -> Ranges:
    if not remove:
        return ranges
    keep = _complement(_merge(remove))
    out = []
    for a, b in ranges:
        i = bisect.bisect_right(keep, (a, _MAX + 1)) - 1
        for c, d in keep[max(i, 0):]:
            if c > b:
                break
            lo, hi = max(a, c), min(b, d)
            if lo <= hi:
                out.append((lo, hi))
    return _merge(out)


def _corrected(base, fix: dict | None) -> Ranges:
    if not fix:
        return _merge(base)
    return _subtract(_merge(list(base) + list(fix["add"])), fix["remove"])


@functools.cache
def category_ranges(cat: str) -> Ranges:
    """A general category (``L``, ``Lu``, ``LC`` …) as Oniguruma holds it."""
    table = _category_table()
    if cat == "LC":
        return _merge(category_ranges("Lu") + category_ranges("Ll") + category_ranges("Lt"))
    if len(cat) == 1:
        base = [r for k, v in table.items() if k[0] == cat for r in v]
    else:
        base = list(table.get(cat, ()))
    if not base:
        raise NotImplementedError(f"Unicode class \\p{{{cat}}} is not a general category")
    return _corrected(base, unicode_tables.CATEGORIES.get(cat))


def _norm_name(name: str) -> str:
    return re.sub(r"[ _\-]", "", name).upper()


@functools.cache
def _script_index() -> dict[str, int]:
    return {alias: i for i, names in enumerate(unicode_scripts.NAMES) for alias in names}


@functools.cache
def script_ranges(name: str) -> Ranges | None:
    """A script's code points as Oniguruma holds them (``Han``, ``Latn``,
    ``Old_Italic`` …; case, spaces, hyphens and underscores ignored), or
    None for a name that is no script."""
    key = _norm_name(name)
    if key in ("UNKNOWN", "ZZZZ"):
        known = _merge((a, b) for a, b, _ in unicode_scripts.RANGES)
        return _complement(known)
    i = _script_index().get(key)
    if i is None:
        return None
    return _merge((a, b) for a, b, j in unicode_scripts.RANGES if j == i)


@functools.cache
def class_ranges(name: str) -> Ranges:
    """Code-point ranges of an Oniguruma property: a general category
    (``L``, ``Lu``, ``Letter``, ``Uppercase_Letter`` …), a script,
    ``White_Space``, ``Word`` (``\\w``), ``Any`` or ``ASCII``."""
    if name == "White_Space":
        return unicode_tables.WHITE_SPACE
    key = _norm_name(name)
    if key in ("WHITESPACE", "SPACE"):
        return unicode_tables.WHITE_SPACE
    if key == "WORD":
        table = _category_table()
        base = (_category_table_letter("L") + _category_table_letter("M") + list(table["Nd"])
                + list(table["Pc"]))
        return _corrected(base, unicode_tables.WORD)
    if key == "ANY":
        return ((0, _MAX),)
    if key == "ASCII":
        return ((0, 0x7F),)
    cat = _LONG_CATEGORIES.get(key)
    if cat is None and 1 <= len(key) <= 2 and key[0] in "LMNPSZC":
        cat = "LC" if key == "LC" else key[0] + key[1:].lower()
    if cat is not None:
        return category_ranges(cat)
    scripts = script_ranges(name)
    if scripts is not None:
        return scripts
    raise NotImplementedError(f"Unicode property \\p{{{name}}} is not ported")


# -- the library's character predicates ----------------------------------------------


@functools.cache
def predicate_ranges(name: str) -> Ranges:
    """The code points a component of the library decides by ``name``:

    - ``numeric``: Rust's ``char::is_numeric`` (``Digits``);
    - ``white_space``: Rust's ``char::is_whitespace`` (``WhitespaceSplit``,
      ``Strip``, ``BertPreTokenizer``);
    - ``punctuation``: ASCII punctuation or P* (``Punctuation``,
      ``BertPreTokenizer``);
    - ``control``: what ``BertNormalizer``'s ``clean_text`` drops besides
      NUL and U+FFFD;
    - ``chinese``: what its ``handle_chinese_chars`` puts between spaces;
    - ``nonspacing_mark``: what ``StripAccents`` drops;
    - ``bert_nonspacing_mark``: what ``BertNormalizer``'s ``strip_accents``
      drops after NFD (another table than ``StripAccents``');
    - ``word``: ``\\w`` of the ``Whitespace`` pre-tokenizer, whose pattern
      runs in Rust's ``regex`` crate (it holds Join_Control; Oniguruma's
      does not).
    """
    t = unicode_tables
    if name == "word":
        table = _category_table()
        base = (_category_table_letter("L") + _category_table_letter("M") + list(table["Nd"])
                + list(table["Pc"]))
        return _corrected(base, t.RUST_WORD)
    if name == "numeric":
        return _corrected(category_ranges("N"), t.RUST_NUMERIC)
    if name == "white_space":
        return t.WHITE_SPACE
    if name == "punctuation":
        base = list(_category_table_letter("P")) + [(ord(c), ord(c)) for c in _ASCII_PUNCT]
        return _corrected(base, t.PUNCTUATION)
    if name == "control":
        base = [r for k in ("Cc", "Cf", "Co") for r in _category_table()[k]]
        return _corrected(_subtract(_merge(base), ((9, 10), (13, 13))), t.BERT_CONTROL)
    if name == "chinese":
        return t.BERT_CHINESE
    if name == "nonspacing_mark":
        return _corrected(_category_table()["Mn"], t.NONSPACING_MARK)
    if name == "bert_nonspacing_mark":
        return _corrected(_category_table()["Mn"], t.BERT_NONSPACING_MARK)
    raise ValueError(f"no character predicate {name!r}")


def _category_table_letter(letter: str) -> list[tuple[int, int]]:
    return [r for k, v in _category_table().items() if k[0] == letter for r in v]


def class_body(ranges: Ranges) -> str:
    """Ranges → the inside of a ``re`` bracket, as \\U escapes."""
    parts = []
    for a, b in ranges:
        parts.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
    return "".join(parts)


@functools.cache
def predicate_regex(name: str) -> re.Pattern:
    """One code point of ``predicate_ranges(name)``."""
    return re.compile(class_regex(predicate_ranges(name)))


# -- case and normalisation ------------------------------------------------------------


@functools.cache
def _lower_table() -> dict[int, str]:
    table = {c: s for c, s in unicode_tables.LOWERCASE.items()}
    table[ord("Σ")] = "σ"  # no final-sigma rule: the library maps each character alone
    return table


def lowercase(text: str) -> str:
    """The library's ``Lowercase``: Rust's ``char::to_lowercase`` of each
    character, without ``str.lower``'s final-sigma context."""
    return text.translate(_lower_table()).lower()


@functools.cache
def _opaque() -> re.Pattern:
    return re.compile(f"({class_regex(unicode_tables.NORMALIZATION_OPAQUE)})")


def normalize(form: str, text: str) -> str:
    """The library's NFC/NFD/NFKC/NFKD: ``unicodedata`` between the code
    points the library's older tables do not know, which stay as they are
    (a starter that decomposes, reorders and composes with nothing)."""
    opaque = _opaque()
    if opaque.search(text) is None:
        return unicodedata.normalize(form, text)
    parts = opaque.split(text)
    return "".join(p if i % 2 else unicodedata.normalize(form, p) for i, p in enumerate(parts))


# -- UnicodeScripts ----------------------------------------------------------------------


@functools.cache
def _script_classes() -> tuple[list[int], list[str]]:
    """Sorted starts and the class of each run, for ``script_class``."""
    names = unicode_scripts.NAMES
    rows = [(a, b, names[i][0]) for a, b, i in unicode_scripts.RANGES]
    fixed = {"HIRAGANA": "HAN", "KATAKANA": "HAN"}
    rows = [(a, b, fixed.get(n, n)) for a, b, n in rows]
    over = sorted(unicode_scripts.UNICODE_SCRIPTS)
    # Overlay the pre-tokenizer's own rows on Oniguruma's.
    cut = _merge((a, b) for a, b, _ in over)
    base = []
    for a, b, n in rows:
        for c, d in _subtract(((a, b),), cut):
            base.append((c, d, n))
    merged = sorted(base + [tuple(r) for r in over])
    starts, classes, nxt = [], [], 0
    for a, b, n in merged:
        if a > nxt:
            starts.append(nxt)
            classes.append("ANY")
        starts.append(a)
        classes.append(n)
        nxt = b + 1
    starts.append(nxt)
    classes.append("ANY")
    return starts, classes


@functools.lru_cache(maxsize=1 << 16)
def script_class(ch: str) -> str:
    """The ``UnicodeScripts`` pre-tokenizer's class of one character: its
    script, with the library's fixed rules (a space is ANY, joining either
    neighbour; U+30FC, Hiragana and Katakana are Han; what its table
    leaves out is ANY)."""
    if ch == " ":
        return "ANY"
    if ch == "ー":
        return "HAN"
    starts, classes = _script_classes()
    return classes[bisect.bisect_right(starts, ord(ch)) - 1]


# -- patterns ------------------------------------------------------------------------------

_ASTRAL = "\\U00010000-\\U0010ffff"


def class_regex(ranges: Ranges) -> str:
    """One code point of ``ranges`` as a ``re`` pattern. ``re`` tests the
    Basic Multilingual Plane part of a class in a bitmap but the part above
    one range at a time, so the part above stands behind a one-range guard
    that most text fails at once."""
    bmp = tuple((a, min(b, 0xFFFF)) for a, b in ranges if a <= 0xFFFF)
    astral = tuple((max(a, 0x10000), b) for a, b in ranges if b > 0xFFFF)
    if not astral:
        return f"[{class_body(bmp)}]" if bmp else "(?!)"
    if not bmp:
        return f"(?=[{_ASTRAL}])[{class_body(astral)}]"
    return f"(?:[{class_body(bmp)}]|(?=[{_ASTRAL}])[{class_body(astral)}])"


def _escape_ranges(letter: str, name: str | None) -> Ranges:
    """The ranges an escape stands for (\\s \\S \\d \\D \\w \\W \\h \\H
    \\p{..} \\P{..})."""
    if letter in "sS":
        r = class_ranges("White_Space")
    elif letter in "dD":
        r = category_ranges("Nd")
    elif letter in "wW":
        r = class_ranges("Word")
    elif letter in "hH":
        r = ((0x30, 0x39), (0x41, 0x46), (0x61, 0x66))
    else:
        r = class_ranges(name)
    return _complement(r) if letter in "SDWHP" else r


_CHAR_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "v": "\v", "a": "\a", "e": "\x1b"}


def _atom(pattern: str, i: int) -> tuple[Ranges | None, int | None, int]:
    """The class atom at ``pattern[i]`` → (ranges of a class escape, or
    None; the code point of a single character, or None; the index after
    it)."""
    c = pattern[i]
    if c != "\\" or i + 1 >= len(pattern):
        return None, ord(c), i + 1
    e = pattern[i + 1]
    if e in "pP":
        if pattern.startswith("{", i + 2):
            end = pattern.index("}", i + 3)
            name, j = pattern[i + 3:end], end + 1
        else:
            name, j = pattern[i + 2], i + 3
        if name.startswith("^"):
            name, e = name[1:], "p" if e == "P" else "P"
        return _escape_ranges(e, name), None, j
    if e in "sSdDwWhH":
        return _escape_ranges(e, None), None, i + 2
    if e == "x":
        if pattern.startswith("{", i + 2):
            end = pattern.index("}", i + 3)
            return None, int(pattern[i + 3:end], 16), end + 1
        return None, int(pattern[i + 2:i + 4], 16), i + 4
    if e == "u":
        return None, int(pattern[i + 2:i + 6], 16), i + 6
    if e == "0":
        return None, 0, i + 2
    if e.isalnum() and e not in _CHAR_ESCAPES:
        raise NotImplementedError(f"pattern escape \\{e} in a character class is not ported")
    return None, ord(_CHAR_ESCAPES.get(e, e)), i + 2


def _bracket(pattern: str, i: int) -> tuple[Ranges, bool, int]:
    """The bracket expression opening at ``pattern[i]`` → (its ranges
    before negation, whether it is negated, the index after it)."""
    n = len(pattern)
    i += 1
    negate = pattern.startswith("^", i)
    i += negate
    items: list[tuple[int, int]] = []
    first = True
    while True:
        if i >= n:
            raise ValueError(f"pattern {pattern!r}: an unterminated character class")
        if pattern[i] == "]" and not first:
            return _merge(items), negate, i + 1
        first = False
        if pattern[i] == "[" or pattern.startswith("&&", i):
            raise NotImplementedError("nested or intersected character classes")
        ranges, lo, i = _atom(pattern, i)
        if ranges is not None:
            items.extend(ranges)
            continue
        if pattern.startswith("-", i) and i + 1 < n and pattern[i + 1] != "]":
            hi_ranges, hi, j = _atom(pattern, i + 1)
            if hi_ranges is None:
                if hi < lo:
                    raise ValueError(f"pattern {pattern!r}: an empty range in a class")
                items.append((lo, hi))
                i = j
                continue
        items.append((lo, lo))


def translate(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json ``Split`` or ``Replace`` →
    a pattern for ``re`` that matches the same strings (leftmost-first
    alternation and backtracking are the same in both engines). Character
    classes become their code-point ranges, resolved here (negation too)
    outside a case-insensitive group; inside one, ``re`` folds case over
    the class as it was written."""
    out: list[str] = []
    i, n = 0, len(pattern)
    nocase = [False]  # per open group: case-insensitive?
    word = None
    while i < n:
        c = pattern[i]
        if c == "[":
            ranges, negate, i = _bracket(pattern, i)
            if nocase[-1]:
                body = class_body(ranges)
                out.append(f"[^{body}]" if negate else f"[{body}]" if body else "(?!)")
                if negate and not body:
                    out[-1] = r"[\s\S]"
            else:
                out.append(class_regex(_complement(ranges) if negate else ranges))
            continue
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pPsSdDwWhH":
                ranges, _, i = _atom(pattern, i)
                out.append(class_regex(ranges))
            elif e in "bB":
                word = word or class_regex(class_ranges("Word"))
                if e == "b":
                    out.append(f"(?:(?<={word})(?!{word})|(?<!{word})(?={word}))")
                else:
                    out.append(f"(?:(?<={word})(?={word})|(?<!{word})(?!{word}))")
                i += 2
            elif e == "z":
                out.append(r"\Z")
                i += 2
            elif e == "Z":
                out.append(r"(?=\n?\Z)")
                i += 2
            elif e == "R":
                out.append(r"(?:\r\n|[\n\x0b\x0c\r\x85\u2028\u2029])")
                i += 2
            elif e == "k" and pattern.startswith("<", i + 2):
                end = pattern.index(">", i + 3)
                out.append(f"(?P={pattern[i + 3:end]})")
                i = end + 1
            elif e in "XKGyY":
                raise NotImplementedError(f"pattern escape \\{e} has no re equivalent here")
            else:
                out.append(pattern[i:i + 2])
                i += 2
            continue
        if c == "(":
            flags = re.match(r"\(\?([imx]*)(?:-([imx]*))?([:)])", pattern[i:])
            if flags:
                on, off, kind = flags.group(1), flags.group(2) or "", flags.group(3)
                value = ("i" in on) or (nocase[-1] and "i" not in off)
                if kind == ")":
                    nocase[-1] = value  # applies to the rest of the group
                else:
                    nocase.append(value)
            elif pattern.startswith("(?<", i) and pattern[i + 3:i + 4] not in ("=", "!"):
                nocase.append(nocase[-1])
                out.append("(?P<")  # a named group
                i += 3
                continue
            else:
                nocase.append(nocase[-1])
        elif c == ")" and len(nocase) > 1:
            nocase.pop()
        elif c in "^$":
            out.append(f"(?m:{c})")  # Ruby syntax: line anchors
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def onig_find_iter(pat: re.Pattern, text: str):
    """(start, end) of each match as Oniguruma's iterator finds them. After
    a match the next search starts where it ended; an empty match right
    where the previous match ended is skipped and the search goes on one
    character further. ``re.finditer`` agrees until its first empty match
    (it keeps such a match and may then match a longer string at the same
    place), so it runs until then."""
    last = None
    for m in pat.finditer(text):
        a, b = m.span()
        if a == b:
            break
        last = b
        yield a, b
    else:
        return
    pos, n = last or 0, len(text)
    while pos <= n:
        m = pat.search(text, pos)
        if m is None:
            return
        a, b = m.span()
        if a == b and last == b:
            pos += 1
            continue
        pos = last = b
        yield a, b
