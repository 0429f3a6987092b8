"""The normalizers of ``tokenizer.json``, each a function str → str, as the
``tokenizers`` library (0.22) defines them: ``NFC``, ``NFD``, ``NFKC``,
``NFKD``, ``Lowercase``, ``Strip``, ``StripAccents``, ``BertNormalizer``,
``Nmt``, ``ByteLevel``, ``Precompiled`` (llm/precompiled_charsmap.py),
``Prepend``, ``Replace`` and ``Sequence``. Character classes and
normalisation forms are the library's (llm/unicode_classes.py)."""

from __future__ import annotations

import re
from typing import Callable

from dynamo_tpu_torch.llm import unicode_classes as U
from dynamo_tpu_torch.llm.precompiled_charsmap import Precompiled
from dynamo_tpu_torch.llm.tok_common import byte_level, pattern, replace, unsupported

Normalizer = Callable[[str], str]

# Nmt: control characters dropped, then these code points made spaces.
_NMT_DROP = re.compile("[\x01-\x08\x0b\x0e-\x1f\x7f\x8f\x9f]")
_NMT_SPACE = re.compile("[\t\n\x0c\r\u1680\u200b-\u200f\u2028\u2029\u2581\ufeff\ufffd]")


def _strip(left: bool, right: bool) -> Normalizer:
    ws = U.class_body(U.predicate_ranges("white_space"))
    lead, trail = re.compile(f"^[{ws}]+"), re.compile(f"[{ws}]+\\Z")

    def strip(s: str) -> str:
        if left:
            s = lead.sub("", s)
        if right:
            s = trail.sub("", s)
        return s

    return strip


def _strip_accents(s: str) -> str:
    return U.predicate_regex("nonspacing_mark").sub("", s)


def _bert(spec: dict) -> Normalizer:
    """BertNormalizer: ``clean_text`` drops NUL, U+FFFD and control
    characters and makes whitespace a space; ``handle_chinese_chars`` puts
    spaces around CJK ideographs; ``strip_accents`` (null: as
    ``lowercase``) decomposes (NFD) and drops non-spacing marks."""
    clean = bool(spec.get("clean_text", True))
    chinese = bool(spec.get("handle_chinese_chars", True))
    lower = bool(spec.get("lowercase", True))
    accents = spec.get("strip_accents")
    accents = lower if accents is None else bool(accents)
    drop = re.compile(f"[\0�{U.class_body(U.predicate_ranges('control'))}]")
    space = re.compile(f"[\t\n\r{U.class_body(U.predicate_ranges('white_space'))}]")
    cjk = re.compile(f"([{U.class_body(U.predicate_ranges('chinese'))}])")
    marks = U.predicate_regex("bert_nonspacing_mark")

    def bert(s: str) -> str:
        if clean:
            s = space.sub(" ", drop.sub("", s))
        if chinese:
            s = cjk.sub(r" \1 ", s)
        if accents:
            s = marks.sub("", U.normalize("NFD", s))
        if lower:
            s = U.lowercase(s)
        return s

    return bert


def normalizer(spec: dict | None) -> Normalizer | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: U.normalize(kind, s)
    if kind == "Lowercase":
        return U.lowercase
    if kind == "Strip":
        return _strip(bool(spec.get("strip_left", True)), bool(spec.get("strip_right", True)))
    if kind == "StripAccents":
        return _strip_accents
    if kind == "BertNormalizer":
        return _bert(spec)
    if kind == "Nmt":
        return lambda s: _NMT_SPACE.sub(" ", _NMT_DROP.sub("", s))
    if kind == "ByteLevel":
        return byte_level
    if kind == "Precompiled":
        return Precompiled(spec["precompiled_charsmap"])
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = pattern(spec["pattern"]), spec["content"]
        return lambda s: replace(pat, content, s)
    if kind == "Sequence":
        parts = [normalizer(n) for n in spec["normalizers"]]

        def seq(s: str) -> str:
            for f in parts:
                s = f(s)
            return s

        return seq
    raise unsupported("normalizer", spec)
