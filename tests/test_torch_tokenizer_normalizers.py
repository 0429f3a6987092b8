"""Each normalizer of the port's tokenizer.json pipeline against the
``tokenizers`` library's own (``normalize_str``), on the CPU.

Every normalizer runs over a mixed-script corpus and over every code point
(surrogates aside) in three contexts, each one string: the code points in
order, each one after an "a", and each one before a combining acute
(U+0301, which reorders and composes). The strings are made once per
module. ``Precompiled`` runs on the xlmr family's charsmap, from
chip_smoke.py's darts-clone writer; its grapheme clusters are swept in
tests/test_torch_tokenizer_precompiled.py.
"""

from __future__ import annotations

import base64
import json

import pytest
from tokenizers import Tokenizer, models

import chip_smoke as C
from dynamo_tpu_torch.llm.tok_normalizers import normalizer
from tokenizer_families import EXTRA
from torch_tokenizer_kinds import CORPUS

TEXTS = EXTRA + CORPUS + C.TOK_FAMILY_TEXTS + [
    "", " ", "  lead and trail 　", "a\x01b\tc​d﻿e▁f\x7f\x8fg\x85",
    "ΑΣ ΣΑ İ ẞ ǅ Ⅻ ⅱ", "ﬁ ㋿ ½ ℌ ① Ｆｕｌｌ", "क्षत्रिय e̖᫁ \U00011935\U00011930",
    "\x00nul � rep \x0b\x0c vt ff", "日本語 中文 \U00020000 한국어"]


def code_points() -> list[int]:
    return [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


@pytest.fixture(scope="module")
def sweeps() -> dict[str, str]:
    cps = code_points()
    return {"alone": "".join(map(chr, cps)),
            "after_a": "".join("a" + chr(c) for c in cps),
            "before_mark": "".join(chr(c) + "́" for c in cps)}


def library(spec: dict):
    base = json.loads(Tokenizer(models.BPE()).to_str())
    base["normalizer"] = spec
    return Tokenizer.from_str(json.dumps(base)).normalizer


def first_difference(got: str, want: str) -> str:
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    return f"at {i}: port {got[i:i + 8]!r} library {want[i:i + 8]!r}"


def assert_same(spec: dict, sweeps: dict[str, str] | None) -> None:
    port, lib = normalizer(spec), library(spec)
    for text in TEXTS:
        assert port(text) == lib.normalize_str(text), (spec, text)
    for name, text in (sweeps or {}).items():
        got, want = port(text), lib.normalize_str(text)
        assert got == want, (spec, name, first_difference(got, want))


BERT = [{"type": "BertNormalizer", "clean_text": a, "handle_chinese_chars": b,
         "strip_accents": c, "lowercase": d}
        for a in (True, False) for b in (True, False) for c in (None, True, False)
        for d in (True, False)]
# Each of BertNormalizer's steps alone, and all of them, sweep every code
# point; every combination runs over the corpus.
BERT_SWEPT = [BERT[0], BERT[-1]] + [
    {"type": "BertNormalizer", "clean_text": k == "clean_text",
     "handle_chinese_chars": k == "handle_chinese_chars", "strip_accents": k == "strip_accents",
     "lowercase": k == "lowercase"}
    for k in ("clean_text", "handle_chinese_chars", "strip_accents", "lowercase")]


@pytest.mark.parametrize("spec", [
    {"type": "NFC"}, {"type": "NFD"}, {"type": "NFKC"}, {"type": "NFKD"}, {"type": "Lowercase"},
    {"type": "Strip", "strip_left": True, "strip_right": True},
    {"type": "Strip", "strip_left": True, "strip_right": False},
    {"type": "Strip", "strip_left": False, "strip_right": True},
    {"type": "StripAccents"}, {"type": "Nmt"}, {"type": "ByteLevel"},
], ids=lambda s: json.dumps(s, ensure_ascii=False))
def test_normalizer_matches_the_library(sweeps, spec):
    assert_same(spec, sweeps)


@pytest.mark.parametrize("spec", [
    {"type": "Sequence", "normalizers": [{"type": "NFD"}, {"type": "StripAccents"},
                                         {"type": "Lowercase"}]},
    {"type": "Replace", "pattern": {"Regex": r"\s+|x*"}, "content": "_"},
    {"type": "Replace", "pattern": {"Regex": r"\b|\p{Han}"}, "content": "|"},
    {"type": "Replace", "pattern": {"String": "a"}, "content": "bb"},
    {"type": "Prepend", "prepend": "▁"},
], ids=lambda s: json.dumps(s, ensure_ascii=False))
def test_composed_normalizer_matches_the_library(spec):
    """Patterns and sequences, over the corpus (their parts sweep every
    code point above and in test_torch_tokenizer_pretokenizers.py)."""
    assert_same(spec, None)


@pytest.mark.parametrize("spec", BERT, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_bert_normalizer_matches_the_library(sweeps, spec):
    assert_same(spec, sweeps if spec in BERT_SWEPT else None)


def test_precompiled_xlmr_charsmap_matches_the_library(sweeps):
    spec = {"type": "Precompiled",
            "precompiled_charsmap": base64.b64encode(C.xlmr_charsmap()).decode()}
    assert_same(spec, sweeps)


@pytest.mark.parametrize("charsmap", ["", None, "AAAAAA==", "CAAAAAA="])
def test_precompiled_charsmap_the_library_refuses_raises(charsmap):
    """Empty, null, an empty trie, a trie longer than the blob."""
    with pytest.raises(BaseException):  # the library panics, at load or at use
        library({"type": "Precompiled", "precompiled_charsmap": charsmap}).normalize_str("a")
    with pytest.raises(ValueError):
        normalizer({"type": "Precompiled", "precompiled_charsmap": charsmap})
