"""The pre-tokenizers of ``tokenizer.json`` as the ``tokenizers`` library
(0.22) defines them: ``Split`` (every behavior, ``invert``), ``ByteLevel``,
``Metaspace``, ``Whitespace``, ``WhitespaceSplit``, ``Punctuation``,
``Digits``, ``BertPreTokenizer``, ``CharDelimiterSplit``, ``FixedLength``,
``UnicodeScripts`` and ``Sequence``.

A pre-tokenizer maps pieces to pieces. A piece is (text, at_start):
at_start marks the piece that begins at the original text's offset 0
(Metaspace's prepend_scheme "first" reads it). Empty pieces are dropped, as
the library drops them.
"""

from __future__ import annotations

import re
from typing import Callable

from dynamo_tpu_torch.llm import unicode_classes as U
from dynamo_tpu_torch.llm.tok_common import byte_level, find_matches, pattern, unsupported

Piece = tuple[str, bool]
PreTokenizer = Callable[[list[Piece]], list[Piece]]

# GPT-2's pre-tokenizer pattern (ByteLevel with use_regex).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def split_spans(spans: list[tuple[int, int, bool]], behavior: str) -> list[tuple[int, int]]:
    """(start, end, is_match) spans → the pieces one ``Split`` behavior
    keeps, as the library's ``NormalizedString::split``."""
    if behavior == "Isolated":
        return [(a, b) for a, b, _ in spans]
    if behavior == "Removed":
        return [(a, b) for a, b, m in spans if not m]
    out: list[list[int]] = []
    prev = False
    if behavior == "Contiguous":
        for a, b, m in spans:
            if m == prev and out:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    elif behavior == "MergedWithPrevious":
        for a, b, m in spans:
            if m and not prev and out:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    elif behavior == "MergedWithNext":
        for a, b, m in reversed(spans):
            if m and not prev and out:
                out[-1][0] = a
            else:
                out.append([a, b])
            prev = m
        out.reverse()
    else:
        raise ValueError(f"tokenizer.json Split behavior {behavior!r} is unknown")
    return [(a, b) for a, b in out]


def _splitter(pat: re.Pattern, behavior: str, invert: bool = False) -> PreTokenizer:
    if behavior not in BEHAVIORS:
        raise ValueError(f"tokenizer.json Split behavior {behavior!r} is unknown")

    def split(pieces: list[Piece]) -> list[Piece]:
        out: list[Piece] = []
        for t, s in pieces:
            spans = find_matches(pat, t)
            if invert:
                spans = [(a, b, not m) for a, b, m in spans]
            out.extend((t[a:b], s and a == 0) for a, b in split_spans(spans, behavior) if a < b)
        return out

    return split


def _predicate(name: str) -> re.Pattern:
    """A character predicate as a one-character pattern: each such
    character is a match of its own, as the library's ``Fn(char)``
    patterns."""
    return U.predicate_regex(name)


def _whitespace_pattern() -> re.Pattern:
    """``Whitespace``'s ``\\w+|[^\\w\\s]+``, its classes those of Rust's
    ``regex`` crate, in which the library runs it."""
    word = U.predicate_ranges("word")
    other = U._complement(U._merge(word + U.predicate_ranges("white_space")))
    return re.compile(f"{U.class_regex(word)}+|{U.class_regex(other)}+")


def _byte_level(spec: dict) -> PreTokenizer:
    prefix = bool(spec.get("add_prefix_space", True))
    regex = re.compile(U.translate(GPT2_PATTERN)) if spec.get("use_regex", True) else None

    def run(pieces: list[Piece]) -> list[Piece]:
        out: list[Piece] = []
        for t, s in pieces:
            if prefix and not t.startswith(" "):
                t = " " + t
            words = [(t[a:b], s and a == 0) for a, b, _ in find_matches(regex, t)] \
                if regex else [(t, s)]
            out.extend((byte_level(u), us) for u, us in words if u)
        return out

    return run


def metaspace_scheme(spec: dict) -> str:
    """Metaspace's ``prepend_scheme``, the legacy ``add_prefix_space``
    read as the library reads it (false only beside "never")."""
    if "replacement" not in spec:
        raise ValueError("Metaspace needs its replacement")
    scheme = spec.get("prepend_scheme", "always")
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"Metaspace prepend_scheme {scheme!r} is unknown")
    if spec.get("add_prefix_space") is False and scheme != "never":
        raise ValueError("Metaspace add_prefix_space does not match its prepend_scheme")
    return scheme


def _metaspace(spec: dict) -> PreTokenizer:
    scheme = metaspace_scheme(spec)
    rep = spec["replacement"]
    split = bool(spec.get("split", True))
    delim = re.compile(re.escape(rep))

    def run(pieces: list[Piece]) -> list[Piece]:
        out: list[Piece] = []
        for t, s in pieces:
            t = t.replace(" ", rep)
            if not t.startswith(rep) and (scheme == "always" or (scheme == "first" and s)):
                t = rep + t
            if not split:
                out.append((t, s))
                continue
            spans = split_spans(find_matches(delim, t), "MergedWithNext")
            out.extend((t[a:b], s and a == 0) for a, b in spans if a < b)
        return out

    return run


def _fixed_length(length: int) -> PreTokenizer:
    if length <= 0:
        raise ValueError("FixedLength length must be positive")

    def run(pieces: list[Piece]) -> list[Piece]:
        return [(t[i:i + length], s and i == 0) for t, s in pieces
                for i in range(0, len(t), length)]

    return run


def _unicode_scripts(pieces: list[Piece]) -> list[Piece]:
    """A cut wherever the script changes, ANY characters joining the
    piece before them; leading ANY characters are dropped, as the
    library's cut points start at the first other character."""
    out: list[Piece] = []
    for t, s in pieces:
        cuts: list[int] = []
        last = None
        for i, ch in enumerate(t):
            script = U.script_class(ch)
            if script != "ANY" and last != "ANY" and last != script:
                cuts.append(i)
            if script != "ANY":
                last = script
        cuts.append(len(t))
        out.extend((t[a:b], s and a == 0) for a, b in zip(cuts, cuts[1:]) if a < b)
    return out


def pre_tokenizer(spec: dict | None) -> PreTokenizer | None:
    """The pre-tokenizer of a spec; an empty piece it is given yields
    nothing (the library holds no empty piece)."""
    if spec is None:
        return None
    run = _pre_tokenizer(spec)
    return lambda pieces: run([p for p in pieces if p[0]])


def _pre_tokenizer(spec: dict) -> PreTokenizer:
    kind = spec["type"]
    if kind == "Split":
        return _splitter(pattern(spec["pattern"]), spec.get("behavior", "Isolated"),
                         bool(spec.get("invert", False)))
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "Whitespace":
        return _splitter(_whitespace_pattern(), "Removed", invert=True)
    if kind == "WhitespaceSplit":
        return _splitter(_predicate("white_space"), "Removed")
    if kind == "Punctuation":
        return _splitter(_predicate("punctuation"), spec.get("behavior", "Isolated"))
    if kind == "Digits":
        return _splitter(_predicate("numeric"),
                         "Isolated" if spec.get("individual_digits") else "Contiguous")
    if kind == "BertPreTokenizer":
        ws = _splitter(_predicate("white_space"), "Removed")
        punct = _splitter(_predicate("punctuation"), "Isolated")
        return lambda pieces: punct(ws(pieces))
    if kind == "CharDelimiterSplit":
        return _splitter(re.compile(re.escape(spec["delimiter"])), "Removed")
    if kind == "FixedLength":
        return _fixed_length(int(spec.get("length", 5)))
    if kind == "UnicodeScripts":
        return _unicode_scripts
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces: list[Piece]) -> list[Piece]:
            for f in parts:
                pieces = f(pieces)
            return pieces

        return seq
    raise unsupported("pre_tokenizer", spec)

