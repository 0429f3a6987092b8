"""The ``Precompiled`` normalizer's grapheme clusters against the
``tokenizers`` library's, on the CPU.

The charsmap (chip_smoke.py's darts-clone writer) maps every assigned code
point but the big uniform blocks (CJK ideographs, Hangul syllables,
private use, tags) to itself. The library looks a cluster of fewer than 6
bytes up whole, by its shortest key prefix, so its output keeps only the
first character of such a cluster: the output shows where clusters begin
and end. Every code point c (surrogates aside) runs in five contexts, each
one string with the code points apart by a newline: after "a" (Extend,
SpacingMark, ZWJ), before "a" (Prepend), before two acutes (Control), after
a Devanagari consonant and virama (InCB Consonant) and after "©" and a
zero-width joiner (Extended_Pictographic).
"""

from __future__ import annotations

import unicodedata

import pytest
from tokenizers import normalizers

import chip_smoke as C
from dynamo_tpu_torch.llm.precompiled_charsmap import Precompiled, clusters


def code_points() -> list[int]:
    return [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


@pytest.fixture(scope="module")
def identity():
    """Every assigned code point but the big uniform blocks (CJK
    ideographs, Hangul syllables, private use, tags) maps to itself, plus a
    few of them; some keys are two characters, one maps to nothing."""
    keep = {0x4E00, 0xAC00, 0xE000, 0xE0001, 0x20000}
    mapping = {}
    for c in code_points():
        ch = chr(c)
        if c not in keep and (unicodedata.category(ch) == "Cn" or 0x3400 <= c <= 0x9FFF
                              or 0xAC00 <= c <= 0xD7A3 or 0x20000 <= c <= 0x3FFFF
                              or 0xE000 <= c <= 0xF8FF or c >= 0xE0000):
            continue
        mapping[ch] = ch
    mapping.update({"ab": "X", "\r\n": "crlf", "é": "E", "​": ""})
    return Precompiled(C.darts_charsmap(mapping)), normalizers.Precompiled(
        C.darts_charsmap(mapping))


@pytest.mark.parametrize("context", ["a{}", "{}a", "{}́́", "क्{}́", "©‍{}́"])
def test_precompiled_cluster_boundaries_match_the_library(identity, context):
    port, lib = identity
    text = "\n".join(context.format(chr(c), chr(c)) for c in code_points())
    got, want = port(text), lib.normalize_str(text)
    if got != want:
        i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        raise AssertionError(f"at {i}: port {got[i - 4:i + 4]!r} library {want[i - 4:i + 4]!r}")


def test_clusters_of_common_sequences():
    assert clusters("e\u0301x") == ["e\u0301", "x"]
    assert clusters("\r\n\n") == ["\r\n", "\n"]
    assert clusters("\U0001F468\u200d\U0001F469\u200d\U0001F467!") == [
        "\U0001F468\u200d\U0001F469\u200d\U0001F467", "!"]
    assert clusters("\U0001F1EB\U0001F1F7\U0001F1EB") == ["\U0001F1EB\U0001F1F7", "\U0001F1EB"]
    assert clusters("\u0915\u094d\u0937a") == ["\u0915\u094d\u0937", "a"]
    assert clusters("\u1100\u1161\u11a8\uac00") == ["\u1100\u1161\u11a8", "\uac00"]
