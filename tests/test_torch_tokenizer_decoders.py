"""Each decoder and post-processor of the port's tokenizer.json pipeline
against the ``tokenizers`` library's own, on the CPU.

Decoders (``decode`` of token lists) run over 400 seeded random lists of
tokens that carry what each decoder acts on (``▁``, ``##``, ``</w>``,
``<pad>``, ``|``, byte tokens, byte-level characters, contractions the
cleanup joins), with their options varied. Post-processors (``encode``
ids of a WordLevel tokenizer, with and without specials) run over the
corpus, alone and in Sequences, where a template hands the next processor
one encoding per piece.
"""

from __future__ import annotations

import json
import random

import pytest
from tokenizers import Tokenizer, models

from dynamo_tpu_torch.llm.tok_common import BYTE_CHAR
from dynamo_tpu_torch.llm.tok_decoders import decoder
from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson
from torch_tokenizer_kinds import CORPUS

POOL = ["▁the", "▁", "▁▁", "cat", "s", "##ing", "##", "do", "not", "n't", "'s", "'", ".", ",",
        "?", "!", "hello</w>", "</w>", "wor", "ld</w>", "<pad>", "|", "a", "a", "b", "<0x41>",
        "<0xC3>", "<0xA9>", "<0xE2>", "Ġhi", "Ċ", "é", "日本", " ", "  x ", "'m", "'re", "'ve",
        " do not", "<unk>", BYTE_CHAR[0xF0], BYTE_CHAR[0x9F], BYTE_CHAR[0x98], BYTE_CHAR[0x80]]


def token_lists(n: int = 400) -> list[list[str]]:
    rng = random.Random(0)
    return [[]] + [[rng.choice(POOL) for _ in range(rng.randint(1, 9))] for _ in range(n)]


def library(part: str, spec: dict) -> Tokenizer:
    base = json.loads(Tokenizer(models.BPE()).to_str())
    base[part] = spec
    return Tokenizer.from_str(json.dumps(base))


@pytest.mark.parametrize("spec", [
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": False},
    {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
    {"type": "Metaspace", "replacement": "a", "add_prefix_space": False,
     "prepend_scheme": "never"},
    {"type": "WordPiece", "prefix": "##", "cleanup": True},
    {"type": "WordPiece", "prefix": "##", "cleanup": False},
    {"type": "WordPiece", "prefix": "wor", "cleanup": True},
    {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|", "cleanup": True},
    {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|", "cleanup": False},
    {"type": "CTC", "pad_token": "a", "word_delimiter_token": "▁", "cleanup": True},
    {"type": "BPEDecoder", "suffix": "</w>"},
    {"type": "BPEDecoder", "suffix": "ld"},
    {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 1},
    {"type": "Strip", "content": "a", "start": 3, "stop": 2},
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"},
        {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
    {"type": "Sequence", "decoders": [{"type": "WordPiece", "prefix": "##", "cleanup": True},
                                      {"type": "BPEDecoder", "suffix": "</w>"}]},
], ids=lambda s: json.dumps(s, ensure_ascii=False))
def test_decoder_matches_the_library(spec):
    port, lib = decoder(spec), library("decoder", spec).decoder
    for tokens in token_lists():
        try:
            want = lib.decode(tokens)
        except BaseException:  # noqa: BLE001 — the library panics: the port must raise too
            with pytest.raises(ValueError):
                port(tokens)
            continue
        assert "".join(port(tokens)) == want, tokens


VOCAB = {w: i for i, w in enumerate(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "<s>", "</s>", "x", "y"]
    + sorted({w for t in CORPUS for w in t.split()}))}


def template(single: str, pair: str, specials: dict[str, list[int]]) -> dict:
    def pieces(text: str) -> list[dict]:
        out = []
        for p in text.split():
            name, _, type_id = p.partition(":")
            kind = "Sequence" if name in ("$A", "$B") else "SpecialToken"
            out.append({kind: {"id": name.lstrip("$"), "type_id": int(type_id or 0)}})
        return out

    return {"type": "TemplateProcessing", "single": pieces(single), "pair": pieces(pair),
            "special_tokens": {n: {"id": n, "ids": ids, "tokens": [n] * len(ids)}
                               for n, ids in specials.items()}}


@pytest.mark.parametrize("spec", [
    {"type": "BertProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2]},
    {"type": "RobertaProcessing", "sep": ["</s>", 5], "cls": ["<s>", 4], "trim_offsets": True,
     "add_prefix_space": True},
    {"type": "RobertaProcessing", "sep": ["</s>", 5], "cls": ["<s>", 4], "trim_offsets": False,
     "add_prefix_space": False},
    template("[CLS] $A [SEP]", "[CLS] $A [SEP] $B:1 [SEP]:1", {"[CLS]": [2], "[SEP]": [3]}),
    template("<s> $A </s>", "<s> $A </s> </s> $B </s>", {"<s>": [4], "</s>": [5]}),
    template("$A x", "$A x $B x", {"x": [6, 7]}),
    template("x $A $A", "$A $B", {"x": [6]}),
    {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
        template("<s> $A", "<s> $A <s> $B", {"<s>": [4]})]},
    {"type": "Sequence", "processors": [
        template("<s> $A", "<s> $A <s> $B", {"<s>": [4]}),
        {"type": "BertProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2]}]},
    {"type": "Sequence", "processors": [
        template("[CLS] $A [SEP]", "$A $B", {"[CLS]": [2], "[SEP]": [3]}),
        {"type": "RobertaProcessing", "sep": ["</s>", 5], "cls": ["<s>", 4]}]},
    {"type": "Sequence", "processors": [
        {"type": "BertProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2]},
        {"type": "RobertaProcessing", "sep": ["</s>", 5], "cls": ["<s>", 4]}]},
    {"type": "Sequence", "processors": [
        {"type": "BertProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2]},
        template("x $A", "$A $B", {"x": [6]})]},
    {"type": "Sequence", "processors": [template("x $A", "$A $B", {"x": [6]}),
                                        template("$A x", "$A $B x", {"x": [6]})]},
], ids=lambda s: json.dumps(s)[:80])
def test_post_processor_matches_the_library(spec):
    full = {"model": {"type": "WordLevel", "vocab": VOCAB, "unk_token": "[UNK]"},
            "pre_tokenizer": {"type": "WhitespaceSplit"}, "post_processor": spec}
    port, lib = TokenizerJson(full), library("post_processor", spec)
    lib = Tokenizer.from_str(json.dumps({**json.loads(lib.to_str()), **full}))
    for text in CORPUS + ["", "x y"]:
        assert port.encode(text) == lib.encode(text).ids, text
        assert port.encode(text, add_special_tokens=False) == lib.encode(
            text, add_special_tokens=False).ids


def test_template_single_naming_b_or_an_unknown_special_raises():
    """The library panics encoding such a template; the port refuses it."""
    for bad in (template("$B", "$A $B", {}), template("[X] $A", "$A $B", {})):
        with pytest.raises(ValueError):
            TokenizerJson({"model": {"type": "WordLevel", "vocab": VOCAB, "unk_token": "[UNK]"},
                           "post_processor": bad})
