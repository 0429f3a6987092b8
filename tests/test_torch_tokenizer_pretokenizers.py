"""Each pre-tokenizer of the port's tokenizer.json pipeline against the
``tokenizers`` library's own (``pre_tokenize_str`` pieces), on the CPU.

Every pre-tokenizer runs over a mixed-script corpus, and every character
predicate (``Whitespace``'s, ``WhitespaceSplit``'s, ``Punctuation``'s,
``Digits``', ``BertPreTokenizer``'s, ``UnicodeScripts``') over every code point
(surrogates aside), in order, as one string made once per module: a predicate shows as
runs of code points in and out of it. The script classes of
``UnicodeScripts`` also run with every code point beside a character of
each of twenty scripts. The classes of ``Split`` patterns sweep every code
point in tests/test_torch_tokenizer_pattern_classes.py.
"""

from __future__ import annotations

import json

import pytest
from tokenizers import Tokenizer, models

import chip_smoke as C
from dynamo_tpu_torch.llm import unicode_scripts
from dynamo_tpu_torch.llm.tok_pretokenizers import BEHAVIORS, pre_tokenizer
from tokenizer_families import EXTRA
from torch_tokenizer_kinds import CORPUS

TEXTS = EXTRA + CORPUS + C.TOK_FAMILY_TEXTS + [
    "", " ", "a", "  lead and trail  ", "xab", "axbxxc", "a b  c", "a,,b,c", "a123b4",
    "どこで生れ。Yes", "Apples are りんご 林檎", " a", "ab 。cd", "áb ́abc", "1a", "日本語ー漢字",
    "a‍b 😀‍😀 ⅱ‌x", "'s 'T x'LL", "\r\n\n \t\x0b", "αβγ abc ١٢٣"]


def code_points() -> list[int]:
    return [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


@pytest.fixture(scope="module")
def sweeps() -> dict[str, str]:
    return {"alone": "".join(map(chr, code_points()))}


def library(spec: dict):
    base = json.loads(Tokenizer(models.BPE()).to_str())
    base["pre_tokenizer"] = spec
    return Tokenizer.from_str(json.dumps(base)).pre_tokenizer


def assert_same(spec: dict, sweeps: dict[str, str] | None) -> None:
    port, lib = pre_tokenizer(spec), library(spec)
    for text in TEXTS:
        want = [p for p, _ in lib.pre_tokenize_str(text)]
        assert [p for p, _ in port([(text, True)])] == want, (spec, text)
    for name, text in (sweeps or {}).items():
        want = [p for p, _ in lib.pre_tokenize_str(text)]
        got = [p for p, _ in port([(text, True)])]
        if got != want:
            i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
            raise AssertionError(f"{spec} {name}: piece {i}: port {got[i:i + 3]!r} "
                                 f"library {want[i:i + 3]!r}")


@pytest.mark.parametrize("spec", [
    {"type": "Whitespace"}, {"type": "WhitespaceSplit"}, {"type": "BertPreTokenizer"},
    {"type": "Digits", "individual_digits": True}, {"type": "Digits", "individual_digits": False},
    {"type": "UnicodeScripts"},
    *({"type": "Punctuation", "behavior": b} for b in BEHAVIORS),
], ids=lambda s: json.dumps(s))
def test_predicate_pre_tokenizer_matches_the_library(sweeps, spec):
    assert_same(spec, sweeps)


def test_unicode_scripts_next_to_each_script(sweeps):
    """Each code point between two characters of every script class."""
    spec = {"type": "UnicodeScripts"}
    port, lib = pre_tokenizer(spec), library(spec)
    cps = code_points()
    for k, (name, *_) in enumerate(unicode_scripts.NAMES[:60:3]):
        rep = next(chr(a) for a, _, i in unicode_scripts.RANGES
                   if unicode_scripts.NAMES[i][0] == name)
        text = "".join(rep + chr(c) for c in (cps if name == "LATIN" else cps[k::20]))
        assert ([p for p, _ in port([(text, True)])]
                == [p for p, _ in lib.pre_tokenize_str(text)]), name


ALIASES = [r"\W", r"\D", r"\S", r"\H", r"\B", r"\p{LC}", r"\p{Letter}",
           r"\p{Uppercase_Letter}", r"\P{N}", r"\p{^L}", r"\p{Latn}", r"\p{Any}", r"\p{Word}",
           r"\p{Hani}", r"\p{Zyyy}", r"\p{old italic}", r"[\p{Greek}\d_-]"]


@pytest.mark.parametrize("cls", ALIASES)
def test_pattern_class_over_the_corpus(cls):
    """Negations, long names and aliases of the classes that
    tests/test_torch_tokenizer_pattern_classes.py sweeps over every code
    point."""
    assert_same({"type": "Split", "pattern": {"Regex": cls + ("" if cls[1] in "bB" else "+")},
                 "behavior": "Isolated", "invert": False}, None)


PATTERNS = [{"Regex": r"\s+"}, {"Regex": r"x*"}, {"String": "a"}, {"String": " "},
            {"Regex": r"\b"}, {"Regex": r"\w+|[^\w\s]+"}, {"Regex": r"^\s*|\s*$"},
            {"Regex": r"(?i:'s|'t)|\p{L}+|\p{N}{1,3}"}, {"Regex": r"x*|b"},
            {"Regex": r"(?<w>\w)\k<w>"}, {"Regex": r"\R"}, {"Regex": r"\z|\A"}]


@pytest.mark.parametrize("behavior", BEHAVIORS)
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS, ids=lambda p: json.dumps(p))
def test_split_matches_the_library(behavior, invert, pattern):
    assert_same({"type": "Split", "pattern": pattern, "behavior": behavior, "invert": invert},
                None)


@pytest.mark.parametrize("spec", [
    {"type": "CharDelimiterSplit", "delimiter": "a"},
    {"type": "CharDelimiterSplit", "delimiter": " "},
    {"type": "FixedLength", "length": 1}, {"type": "FixedLength", "length": 3},
    {"type": "FixedLength", "length": 5},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": False},
    {"type": "Metaspace", "replacement": "_", "add_prefix_space": True},
    {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False,
     "prepend_scheme": "never"},
    {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False},
    {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}]},
    {"type": "Sequence", "pretokenizers": [{"type": "Punctuation", "behavior": "Contiguous"},
                                           {"type": "ByteLevel", "add_prefix_space": False,
                                            "trim_offsets": True, "use_regex": True},
                                           {"type": "Digits", "individual_digits": False}]},
], ids=lambda s: json.dumps(s, ensure_ascii=False))
def test_pre_tokenizer_matches_the_library(spec):
    assert_same(spec, None)


@pytest.mark.parametrize("spec", [
    {"type": "Split", "pattern": {"String": " "}, "behavior": "Dropped", "invert": False},
    {"type": "Punctuation", "behavior": "Dropped"},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "sometimes"},
    {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False},
    {"type": "FixedLength", "length": 0},
    {"type": "Metaspace", "prepend_scheme": "always"},
])
def test_option_the_library_refuses_raises(spec):
    """Values the library does not define (or, FixedLength 0, panics on)
    fail to load, named."""
    with pytest.raises(ValueError):
        pre_tokenizer(spec)
