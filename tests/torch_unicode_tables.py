"""The port's Unicode tables, read off the ``tokenizers`` library.

The port's tokenizer (dynamo_tpu_torch/llm/) runs on the standard library,
whose ``unicodedata`` is Unicode 15.0 in Python 3.12. The library decides
characters by tables of other versions: Oniguruma's (16.0) for pattern
classes, Rust's ``char`` methods, the ``unicode_categories`` crate and its
own normalisation and script tables. Each function here sweeps every code
point (surrogates aside) through the library and returns what the port
needs beside ``unicodedata``; ``render_*`` writes them as the committed
modules ``unicode_tables.py`` and ``unicode_scripts.py``, which
tests/test_torch_tokenizer_tables.py regenerates and compares.

Two tables have no library call that lists them: the script of a code
point and its grapheme-cluster properties (Grapheme_Cluster_Break,
Extended_Pictographic, Indic_Conjunct_Break). Both start from the
``regex`` module (a test dependency, Unicode 17.0), cut to what the
library's Oniguruma holds assigned; the scripts are then checked class by
class against Oniguruma's ``\\p{..}`` and ``UnicodeScripts``, and the
cluster properties overridden wherever the library's ``Precompiled``
normalizer shows otherwise (``grapheme_breaks``).

Regenerate: ``python tests/torch_unicode_tables.py``.
"""

from __future__ import annotations

import collections
import functools
import sys
import unicodedata as ud
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))  # chip_smoke.py: the charsmap writer
LLM = REPO / "dynamo_tpu_torch" / "llm"

ASCII_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"


@functools.cache
def code_points() -> list[int]:
    return [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


def ranges(cps) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for c in sorted(cps):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return tuple((a, b) for a, b in out)


def removed(pre, cps: list[int]) -> set[int]:
    """The code points of ``cps`` that the pre-tokenizer ``pre`` drops when
    it runs over them as one string."""
    text = "".join(map(chr, cps))
    keep = bytearray(len(text))
    for _, (a, b) in pre.pre_tokenize_str(text):
        keep[a:b] = b"\x01" * (b - a)
    return {cps[i] for i in range(len(cps)) if not keep[i]}


@functools.cache
def _categories() -> dict[str, list[int]]:
    out: dict[str, list[int]] = collections.defaultdict(list)
    for c in code_points():
        out[ud.category(chr(c))].append(c)
    return out


def _category(prefixes: str = "", cats=()) -> set[int]:
    return {c for k, v in _categories().items() if k[0] in prefixes or k in cats for c in v}


def _split(pattern: str) -> set[int]:
    from tokenizers import Regex, pre_tokenizers

    return removed(pre_tokenizers.Split(Regex(pattern), "removed"), code_points())


def _fix(lib: set[int], base: set[int]) -> dict:
    return {"add": ranges(lib - base), "remove": ranges(base - lib)}


# -- character classes and predicates ------------------------------------------------


CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd",
              "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc",
              "Cf", "Cs", "Co", "Cn")


def onig_categories() -> dict:
    """Oniguruma's general categories where they differ from
    ``unicodedata``'s: each one-letter class, Cn and Co swept over every
    code point; each other two-letter class over the code points that
    either side holds in its one-letter class."""
    from tokenizers import Regex, pre_tokenizers

    out = {}
    for letter in "LMNPSZC":
        lib = _split(r"\p{%s}" % letter)
        fix = _fix(lib, _category(letter))
        if fix["add"] or fix["remove"]:
            out[letter] = fix
        cps = sorted(lib | _category(letter))
        for cat in (k for k in CATEGORIES if k[0] == letter and k != "Cs"):
            if cat in ("Cn", "Co"):
                sub = _split(r"\p{%s}" % cat)
            else:
                sub = removed(pre_tokenizers.Split(Regex(r"\p{%s}" % cat), "removed"), cps)
            fix = _fix(sub, _category("", (cat,)))
            if fix["add"] or fix["remove"]:
                out[cat] = fix
    return out


def onig_word() -> dict:
    """Oniguruma's ``\\w`` against L, M, Nd and Pc."""
    return _fix(_split(r"\w"), _category("LM", ("Nd", "Pc")))


def whitespace_word() -> dict:
    """The ``Whitespace`` pre-tokenizer's ``\\w`` (its pattern runs in Rust's
    ``regex`` crate, whose ``\\w`` holds Join_Control, not in Oniguruma)
    against L, M, Nd and Pc. Every code point stands between two "a": a
    word character joins them, white space is dropped, any other is a
    piece of its own."""
    from tokenizers import pre_tokenizers

    cps = code_points()
    text = "a" + "".join(chr(c) + "a" for c in cps)
    lib: set[int] = set()
    for p, (a, b) in pre_tokenizers.Whitespace().pre_tokenize_str(text):
        if "a" in p:
            lib.update(cps[i // 2] for i in range(a, b) if i % 2)
    return _fix(lib, _category("LM", ("Nd", "Pc")))


def lib_punctuation() -> dict:
    """``Punctuation`` / ``BertPreTokenizer``: ASCII punctuation or the
    ``unicode_categories`` crate's P*."""
    from tokenizers import pre_tokenizers

    base = _category("P") | {ord(c) for c in ASCII_PUNCT}
    return _fix(removed(pre_tokenizers.Punctuation("removed"), code_points()), base)


def lib_numeric() -> dict:
    """``Digits``: Rust's ``char::is_numeric``. Every code point stands
    between two NULs: a numeric one comes out as a piece of its own."""
    from tokenizers import pre_tokenizers

    text = "".join(chr(c) + "\0" for c in code_points())
    lib = {ord(p) for p, _ in pre_tokenizers.Digits(False).pre_tokenize_str(text)
           if len(p) == 1 and p != "\0"}
    return _fix(lib, _category("N"))


def lib_white_space() -> tuple:
    """Rust's ``char::is_whitespace`` (``WhitespaceSplit``, ``Strip``)."""
    from tokenizers import pre_tokenizers

    return ranges(removed(pre_tokenizers.WhitespaceSplit(), code_points()))


def _per_char(normalizer) -> dict[int, str]:
    return {c: normalizer.normalize_str(chr(c)) for c in code_points()}


def bert_control() -> dict:
    """``BertNormalizer``'s ``clean_text``: the code points it drops (NUL,
    U+FFFD and the crate's Cc/Cf/Co, tab, newline and return aside)."""
    from tokenizers import normalizers

    out = _per_char(normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                               strip_accents=False, lowercase=False))
    lib = {c for c, s in out.items() if s == ""} - {0, 0xFFFD}
    return _fix(lib, _category("", ("Cc", "Cf", "Co")) - {9, 10, 13})


def bert_chinese() -> tuple:
    """``BertNormalizer``'s ``handle_chinese_chars``: the code points it
    puts between spaces."""
    from tokenizers import normalizers

    out = _per_char(normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=True,
                                               strip_accents=False, lowercase=False))
    return ranges(c for c, s in out.items() if s != chr(c))


def nonspacing_marks() -> dict:
    """``StripAccents``: the crate's Mn."""
    from tokenizers import normalizers

    out = _per_char(normalizers.StripAccents())
    return _fix({c for c, s in out.items() if s == ""}, _category("", ("Mn",)))


def bert_nonspacing_marks() -> dict:
    """``BertNormalizer``'s ``strip_accents``: the code points it drops
    after NFD (a table other than ``StripAccents``'). A code point that NFD
    changes is decided by its parts, swept on their own."""
    from tokenizers import normalizers

    nfd = normalizers.NFD()
    out = _per_char(normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=False,
                                               strip_accents=True, lowercase=False))
    lib = {c for c, s in out.items() if s == "" and nfd.normalize_str(chr(c)) == chr(c)}
    return _fix(lib, _category("", ("Mn",)))


def lowercase() -> dict[int, str]:
    """``Lowercase`` (Rust's ``char::to_lowercase``, character by
    character) where it differs from ``str.lower`` of the character."""
    from tokenizers import normalizers

    out = _per_char(normalizers.Lowercase())
    return {c: s for c, s in out.items() if s != chr(c).lower()}


def normalization_opaque() -> tuple:
    """Code points the library's NFC/NFD/NFKC/NFKD (an older Unicode) does
    not know but ``unicodedata`` does: those it leaves unchanged alone,
    those whose combining class it takes for 0 (it does not reorder them),
    and the second half of compositions it does not make."""
    from tokenizers import normalizers

    nfkd, nfd, nfc = normalizers.NFKD(), normalizers.NFD(), normalizers.NFC()
    out = set()
    for c in code_points():
        ch = chr(c)
        if nfkd.normalize_str(ch) != ud.normalize("NFKD", ch):
            out.add(c)
        k = ud.combining(ch)
        if k and c not in out:
            s = ch + "̴" if k > 1 else "́" + ch
            if nfd.normalize_str(s) != ud.normalize("NFD", s):
                out.add(c)
        d = ud.normalize("NFD", ch)
        if len(d) > 1 and ud.normalize("NFC", d) == ch and nfc.normalize_str(d) != ch:
            out.add(ord(d[-1]))
    return ranges(out)


# -- scripts -------------------------------------------------------------------------


def _regex_scripts() -> tuple[dict[int, list[str]], dict[int, list[int]]]:
    import regex
    import regex._regex_core as rc

    names: dict[int, list[str]] = collections.defaultdict(list)
    for k, v in rc.PROPERTIES["SCRIPT"][1].items():
        names[v].append(k)
    text = "".join(map(chr, code_points()))
    members = {}
    for v, ks in names.items():
        cps = [ord(m) for m in regex.findall(r"\p{Script=%s}" % ks[0], text)]
        if cps:
            members[v] = cps
    return names, members


def onig_scripts() -> dict:
    """Oniguruma's scripts: ``names`` (each script's long name first, then
    the aliases Oniguruma takes, upper case without separators) and
    ``ranges`` ((first, last, index into names), Unknown left out)."""
    from tokenizers import Regex, pre_tokenizers

    def accepts(name: str) -> bool:
        try:
            pre_tokenizers.Split(Regex(r"\p{%s}" % name), "removed")
            return True
        except Exception:  # noqa: BLE001 — Oniguruma refuses the name
            return False

    names, members = _regex_scripts()
    script_of: dict[int, int] = {}
    taken = {}
    for v, ks in names.items():
        ok = sorted((k for k in ks if accepts(k)), key=lambda k: (len(k) == 4, -len(k), k))
        if not ok or v not in members:
            continue
        taken[v] = ok
        pre = pre_tokenizers.Split(Regex(r"\p{%s}" % ok[0]), "removed")
        hit = removed(pre, members[v])
        for c in hit:
            script_of[c] = v
    # What Oniguruma does not hold in a script it knows is Unknown there.
    unknown = [c for c in code_points() if c not in script_of]
    pre = pre_tokenizers.Split(Regex(r"\p{Unknown}"), "removed")
    assert len(removed(pre, unknown)) == len(unknown), "a script Oniguruma knows under another name"
    order = sorted(v for v in taken if v != 0)
    index = {v: i for i, v in enumerate(order)}
    rows = []
    for c in sorted(script_of):
        v = script_of[c]
        if v == 0:
            continue
        i = index[v]
        if rows and rows[-1][2] == i and rows[-1][1] == c - 1:
            rows[-1][1] = c
        else:
            rows.append([c, c, i])
    return {"names": tuple(tuple(taken[v]) for v in order),
            "ranges": tuple(tuple(r) for r in rows)}


def _onig_script_of(scripts: dict) -> dict[int, str]:
    out = {}
    for a, b, i in scripts["ranges"]:
        for c in range(a, b + 1):
            out[c] = scripts["names"][i][0]
    return out


def unicode_scripts_classes(scripts: dict) -> dict:
    """The ``UnicodeScripts`` pre-tokenizer's own script table where it
    differs from Oniguruma's: (first, last, script) with ``ANY`` for code
    points that join either neighbour (the table leaves them out). The
    fixed rules (space, U+30FC, Hiragana and Katakana as Han, what
    Oniguruma holds Unknown as ANY) are the port's code, not rows here."""
    from tokenizers import pre_tokenizers

    us = pre_tokenizers.UnicodeScripts()
    onig = _onig_script_of(scripts)

    def fixed(name: str) -> str:
        return {"HIRAGANA": "HAN", "KATAKANA": "HAN", "UNKNOWN": "ANY"}.get(name, name)

    groups: dict[str, list[int]] = collections.defaultdict(list)
    for c in code_points():
        if c not in (0x20, 0x30FC):
            groups[fixed(onig.get(c, "UNKNOWN"))].append(c)

    def pieces(text: str) -> list[str]:
        return [p for p, _ in us.pre_tokenize_str(text)]

    # A representative of each class as the library sees it: the group's
    # first code point that a Latin (or, for Latin, a Greek) letter splits
    # from and that is not ANY.
    cls: dict[int, str] = {}
    reps: dict[str, str] = {}
    for name, cps in groups.items():
        other = "α" if name == "LATIN" else "a"
        text = "".join(chr(c) + other for c in cps)
        # Leading ANY code points are dropped; a code point of another
        # class than `other` starts a piece of its own.
        for p in pieces(text):
            if p[0] != other:
                reps.setdefault(name, p[0])
                break
    names = sorted(reps)
    for x in names:
        for y in names:
            if x < y and pieces(reps[x] + reps[y]) == [reps[x] + reps[y]]:
                raise AssertionError(f"the library holds {x} and {y} in one class")
    for name, cps in groups.items():
        r = reps.get(name)
        for c in cps:
            ch = chr(c)
            got = pieces(ch + r) if r is not None else pieces(ch + "a")
            if got == [r or "a"]:
                cls[c] = "ANY"  # dropped at the start: it joins anything
            elif r is not None and got == [ch + r]:
                cls[c] = name
            else:
                cls[c] = None  # another class: found below
    rest = [c for c, v in cls.items() if v is None]
    for c in rest:
        ch = chr(c)
        for name, r in reps.items():
            if pieces(ch + r) == [ch + r]:
                cls[c] = name
                break
        else:
            raise AssertionError(f"U+{c:04X}: no script class of the library's holds it")
    out = []
    for c in sorted(cls):
        want = cls[c]
        if want == fixed(onig.get(c, "UNKNOWN")):
            continue
        if out and out[-1][2] == want and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c, want])
    return tuple(tuple(r) for r in out)


# -- grapheme clusters -----------------------------------------------------------------


GCB_VALUES = ("CR", "LF", "CONTROL", "EXTEND", "ZWJ", "REGIONALINDICATOR", "PREPEND",
              "SPACINGMARK", "L", "V", "T", "LV", "LVT")


# Code points whose grapheme-cluster properties the Precompiled probe does
# not look at: uniform blocks of Other (CJK ideographs, Tangut, private
# use) and the Hangul syllables, whose clusters are 6 bytes or more.
_UNIFORM = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xAC00, 0xD7A3), (0xE000, 0xF8FF),
            (0x17000, 0x187FF), (0x20000, 0x3FFFF), (0xF0000, 0x10FFFF))


def _probed(unknown: set[int]) -> list[int]:
    """The code points the probe looks at: assigned ones, unassigned
    default ignorables (Control) and the pictographic blocks (whose
    unassigned code points are Extended_Pictographic), outside
    ``_UNIFORM``; LF and CR, whose properties are fixed, aside."""
    import regex

    control = {ord(m) for m in regex.findall(r"\p{Grapheme_Cluster_Break=Control}",
                                             "".join(map(chr, code_points())))}
    return [c for c in code_points() if c not in (0x0A, 0x0D)
            and (c not in unknown or c in control or 0x1F000 <= c <= 0x1FFFF)
            and not any(a <= c <= b for a, b in _UNIFORM)]


def _precompiled_probe(cps: list[int]) -> dict[str, list[str]]:
    """Each code point c in contexts, through the library's Precompiled
    normalizer with a charsmap mapping every probed code point to itself:
    a grapheme cluster of fewer than 6 bytes comes out as its first
    character, so each context shows whether c joined its neighbours."""
    import chip_smoke
    from tokenizers import normalizers

    keys = {chr(c): chr(c) for c in cps}
    lib = normalizers.Precompiled(chip_smoke.darts_charsmap(keys))
    contexts = {"after": "a{}", "before": "{}a", "marks": "{}\u0301\u0301",
                "consonant": "\u0915\u094d{}\u0301", "linker": "\u0915{}\u0916\u0301",
                "extend": "\u0915\u094d{}\u0916\u0301", "pict": "\u00a9\u200d{}\u0301"}
    out = {}
    for name, ctx in contexts.items():
        text = "\n".join(ctx.format(chr(c)) for c in cps)
        out[name] = lib.normalize_str(text).split("\n")
    return out


def grapheme_breaks(unknown: set[int]) -> dict:
    """Grapheme_Cluster_Break (Other left out), Extended_Pictographic and
    Indic_Conjunct_Break (Linker, Consonant, Extend) as the library's
    segmentation (Unicode 16.0) has them.

    The ``regex`` module (Unicode 17.0) gives the values; code points
    Oniguruma holds unassigned become Other (or stay Control). Then the
    library is probed (``_precompiled_probe``) and overrides the module
    wherever it shows otherwise: a code point that joins a following "a"
    is Prepend; one that joins a preceding "a" is Extend, ZWJ or
    SpacingMark; one two acutes do not join is Control; ``क्`` + c + acute
    joined makes c an InCB Consonant; a joiner between ``क`` and ``ख`` an
    InCB Linker, or Extend after ``क्``; ``©`` ZWJ c joined makes c
    Extended_Pictographic."""
    import regex

    text = "".join(map(chr, code_points()))
    gcb: dict[int, str] = {}
    for name in GCB_VALUES:
        for m in regex.finditer(r"\p{Grapheme_Cluster_Break=%s}" % name, text):
            c = ord(m.group())
            if name == "CONTROL" or c not in unknown:
                gcb[c] = name
    pict = {ord(m) for m in regex.findall(r"\p{Extended_Pictographic}", text)}
    incb: dict[int, str] = {}
    for name in ("LINKER", "CONSONANT", "EXTEND"):
        for m in regex.finditer(r"\p{Indic_Conjunct_Break=%s}" % name, text):
            if ord(m.group()) not in unknown:
                incb[ord(m.group())] = name
    cps = _probed(unknown)
    seen = _precompiled_probe(cps)
    for i, c in enumerate(cps):
        ch = chr(c)
        before = seen["before"][i] == ch
        after = seen["after"][i] == "a"
        control = seen["marks"][i] == ch + "\u0301"
        small = len(ch.encode("utf-8")) <= 3
        if before:
            gcb[c] = "PREPEND"
        elif after:
            if gcb.get(c) not in ("EXTEND", "ZWJ", "SPACINGMARK"):
                gcb[c] = "EXTEND"
        elif control:
            if gcb.get(c) not in ("CONTROL", "CR", "LF"):
                gcb[c] = "CONTROL"
        elif gcb.get(c) in ("PREPEND", "EXTEND", "ZWJ", "SPACINGMARK", "CONTROL", "CR", "LF"):
            del gcb[c]
        if after:
            if seen["linker"][i] == "\u0915" + ch + "\u0916\u0301":
                incb[c] = "LINKER"
            elif seen["extend"][i] == "\u0915\u094d" + ch + "\u0916\u0301":
                incb[c] = "EXTEND"
            else:
                incb.pop(c, None)
        elif not (before or control):
            if small:  # a cluster of a wider one and an acute is 6 bytes: not probed
                if seen["consonant"][i] == "\u0915\u094d" + ch + "\u0301":
                    incb[c] = "CONSONANT"
                else:
                    incb.pop(c, None)
            if seen["pict"][i] == "\u00a9\u200d" + ch + "\u0301":
                pict.add(c)
            else:
                pict.discard(c)
    rows = collections.defaultdict(set)
    for c, v in gcb.items():
        rows[v].add(c)
    inrows = collections.defaultdict(set)
    for c, v in incb.items():
        inrows[v].add(c)
    return {"gcb": tuple(sorted((a, b, v) for v, cs in rows.items() for a, b in ranges(cs))),
            "pict": ranges(pict),
            "incb": tuple(sorted((a, b, v) for v, cs in inrows.items() for a, b in ranges(cs)))}


# -- all tables and their modules --------------------------------------------------------


# Every table of unicode_tables.py but the grapheme ones, by its name there.
TABLES = {
    "CATEGORIES": onig_categories, "WORD": onig_word, "RUST_WORD": whitespace_word,
    "WHITE_SPACE": lib_white_space, "RUST_NUMERIC": lib_numeric,
    "PUNCTUATION": lib_punctuation, "BERT_CONTROL": bert_control, "BERT_CHINESE": bert_chinese,
    "NONSPACING_MARK": nonspacing_marks, "BERT_NONSPACING_MARK": bert_nonspacing_marks,
    "LOWERCASE": lowercase, "NORMALIZATION_OPAQUE": normalization_opaque,
}


def tables() -> dict:
    return {k: f() for k, f in TABLES.items()}


def _fmt(value, indent: int = 4) -> str:
    """A literal with a few items a line."""
    if isinstance(value, dict):
        items = [f"{k!r}: {_fmt(v, indent + 4)}" for k, v in value.items()]
        return "{" + _wrap(items, indent) + "}"
    if isinstance(value, tuple) and value and isinstance(value[0], tuple):
        items = [_tuple(v) for v in value]
        return "(" + _wrap(items, indent, trailing=len(items) == 1) + ")"
    if isinstance(value, tuple):
        return _tuple(value)
    return repr(value)


def _tuple(t) -> str:
    parts = []
    for x in t:
        if isinstance(x, int) and x > 9:
            parts.append(f"0x{x:05X}")
        elif isinstance(x, tuple):
            parts.append(_tuple(x))
        else:
            parts.append(repr(x))
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def _wrap(items: list[str], indent: int, trailing: bool = False) -> str:
    if not items:
        return ""
    lines, line = [], ""
    for it in items:
        piece = it + ", "
        if line and len(line) + len(piece) + indent > 96:
            lines.append(line.rstrip())
            line = ""
        line += piece
    lines.append(line.rstrip().rstrip(",") + ("," if trailing else ""))
    pad = " " * indent
    return "\n" + "\n".join(pad + ln for ln in lines) + "\n" + " " * (indent - 4)


TABLES_HEAD = '''"""Unicode tables that make ``unicodedata`` (Unicode 15.0 in Python 3.12)
decide characters as the ``tokenizers`` library (0.22) does. Generated by
``python tests/torch_unicode_tables.py`` from the library and the ``regex``
module; tests/test_torch_tokenizer_tables.py regenerates and compares them.
Do not edit by hand.

Ranges are (first, last) code points. A ``{"add", "remove"}`` pair
corrects the ``unicodedata`` class named in llm/unicode_classes.py.
"""

# fmt: off
'''

SCRIPTS_HEAD = '''"""Unicode scripts as Oniguruma (in ``tokenizers`` 0.22) holds them, for
``\\\\p{<Script>}`` in patterns, and the ``UnicodeScripts`` pre-tokenizer's
own table where it differs. ``unicodedata`` has no Script property.
Generated by ``python tests/torch_unicode_tables.py`` (from the ``regex``
module's scripts, each checked against Oniguruma's); tests/
test_torch_tokenizer_tables.py regenerates and compares. Do not edit by
hand.

``NAMES[i]``: a script's long name, then the aliases Oniguruma takes (upper
case, without spaces, hyphens or underscores). ``RANGES``: (first, last, i);
a code point in none is Unknown. ``UNICODE_SCRIPTS``: (first, last, name)
where the pre-tokenizer's class differs from ``RANGES``; ``ANY`` joins
either neighbour.
"""

# fmt: off
'''


def render_tables(t: dict, graphemes: dict) -> str:
    body = [TABLES_HEAD]
    for k, v in t.items():
        body.append(f"{k} = {_fmt(v)}\n")
    body.append("# Grapheme_Cluster_Break (first, last, value); Other is left out.\n")
    body.append(f"GRAPHEME_CLUSTER_BREAK = {_fmt(graphemes['gcb'])}\n")
    body.append(f"EXTENDED_PICTOGRAPHIC = {_fmt(graphemes['pict'])}\n")
    body.append("# Indic_Conjunct_Break (first, last, value); None is left out.\n")
    body.append(f"INDIC_CONJUNCT_BREAK = {_fmt(graphemes['incb'])}\n")
    return "\n".join(body)


def render_scripts(scripts: dict, classes) -> str:
    return "\n".join([SCRIPTS_HEAD, f"NAMES = {_fmt(scripts['names'])}\n",
                      f"RANGES = {_fmt(scripts['ranges'])}\n",
                      f"UNICODE_SCRIPTS = {_fmt(classes)}\n"])


def unknown_code_points() -> set[int]:
    return _split(r"\p{Cn}")


def main() -> int:
    scripts = onig_scripts()
    (LLM / "unicode_scripts.py").write_text(
        render_scripts(scripts, unicode_scripts_classes(scripts)), encoding="utf-8")
    (LLM / "unicode_tables.py").write_text(
        render_tables(tables(), grapheme_breaks(unknown_code_points())), encoding="utf-8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
