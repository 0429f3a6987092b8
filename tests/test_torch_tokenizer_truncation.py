"""The ``truncation`` and ``padding`` of a tokenizer.json, in the port's
``load_tokenizer`` against the JAX package's (the ``tokenizers``
library's ``encode(text).ids``), on the CPU.

A WordLevel tokenizer of single letters encodes 20-word texts with Right
and Left truncation (with a stride, and at lengths below the specials the
post-processor adds, where the library sets no limit), with and without a
BertProcessing or TemplateProcessing that adds specials, and with
``Fixed``, ``pad_to_multiple_of`` and ``BatchLongest`` padding on either
side. Where the library refuses (OnlySecond with one sequence, a stride not
below the length kept) the port raises too.
"""

from __future__ import annotations

import json

import pytest

from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

LETTERS = "abcdefghijklmnopqrstuvwxyz"
VOCAB = {c: i for i, c in enumerate(LETTERS)} | {"[UNK]": 26, "[CLS]": 27, "[SEP]": 28,
                                                 "[PAD]": 29}
TEXTS = [" ".join(LETTERS[:20]), "a b c", "", "q", " ".join(LETTERS), "z y x w v u t s"]
POST = {
    None: None,
    "bert": {"type": "BertProcessing", "sep": ["[SEP]", 28], "cls": ["[CLS]", 27]},
    "template": {"type": "TemplateProcessing",
                 "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                            {"Sequence": {"id": "A", "type_id": 0}}],
                 "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                          {"Sequence": {"id": "B", "type_id": 1}}],
                 "special_tokens": {"[CLS]": {"id": "[CLS]", "ids": [27], "tokens": ["[CLS]"]}}},
}


def write(tmp_path, name: str, truncation=None, padding=None, post=None) -> dict:
    spec = {"version": "1.0", "truncation": truncation, "padding": padding, "added_tokens": [
        {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True} for t, i in VOCAB.items() if t.startswith("[")],
        "normalizer": None, "pre_tokenizer": {"type": "WhitespaceSplit"},
        "post_processor": POST[post], "decoder": None,
        "model": {"type": "WordLevel", "vocab": VOCAB, "unk_token": "[UNK]"}}
    path = tmp_path / name
    path.mkdir()
    (path / "tokenizer.json").write_text(json.dumps(spec))
    return {"type": "hf", "path": str(path)}


def trunc(max_length: int, direction: str = "Right", stride: int = 0,
          strategy: str = "LongestFirst") -> dict:
    return {"max_length": max_length, "stride": stride, "strategy": strategy,
            "direction": direction}


def pad(strategy, direction: str = "Right", multiple=None) -> dict:
    return {"strategy": strategy, "direction": direction, "pad_to_multiple_of": multiple,
            "pad_id": 29, "pad_type_id": 0, "pad_token": "[PAD]"}


def both(spec: dict, text: str):
    """(port ids, library ids); an error on either side as its type name,
    and the other side must fail too."""
    try:
        want = jax_load(spec).encode(text)
    except BaseException as e:  # noqa: BLE001 — the library's errors and panics
        with pytest.raises(ValueError):
            load_tokenizer(spec).encode(text)
        return type(e).__name__, type(e).__name__
    return load_tokenizer(spec).encode(text), want


def test_the_five_and_the_forty(tmp_path):
    """The two cases the port ignored: max_length 5 keeps 5 of 20 ids, and
    Fixed(40) padding gives 40."""
    text = TEXTS[0]
    spec = write(tmp_path, "t5", truncation=trunc(5))
    assert load_tokenizer(spec).encode(text) == jax_load(spec).encode(text) == list(range(5))
    spec = write(tmp_path, "p40", padding=pad({"Fixed": 40}))
    got = load_tokenizer(spec).encode(text)
    assert got == jax_load(spec).encode(text) and len(got) == 40 and got[20:] == [29] * 20


@pytest.mark.parametrize("post", list(POST))
@pytest.mark.parametrize("direction", ["Right", "Left"])
@pytest.mark.parametrize("max_length, stride", [(5, 0), (5, 2), (1, 0), (2, 0), (3, 1),
                                                (0, 0), (25, 0), (4, 3)])
def test_truncation_matches_the_library(tmp_path, post, direction, max_length, stride):
    spec = write(tmp_path, "t", truncation=trunc(max_length, direction, stride), post=post)
    for text in TEXTS:
        got, want = both(spec, text)
        assert got == want, text


@pytest.mark.parametrize("strategy", ["OnlyFirst", "OnlySecond"])
def test_truncation_strategies_match_the_library(tmp_path, strategy):
    for max_length in (3, 30):
        spec = write(tmp_path, f"s{max_length}", truncation=trunc(max_length, strategy=strategy),
                     post="bert")
        for text in TEXTS:
            got, want = both(spec, text)
            assert got == want, (max_length, text)


@pytest.mark.parametrize("post", list(POST))
@pytest.mark.parametrize("direction", ["Right", "Left"])
@pytest.mark.parametrize("strategy, multiple", [({"Fixed": 40}, None), ({"Fixed": 8}, None),
                                                ({"Fixed": 5}, 4), ({"Fixed": 5}, 0),
                                                ("BatchLongest", None), ("BatchLongest", 8)])
def test_padding_matches_the_library(tmp_path, post, direction, strategy, multiple):
    spec = write(tmp_path, "p", padding=pad(strategy, direction, multiple), post=post)
    for text in TEXTS:
        got, want = both(spec, text)
        assert got == want, text


@pytest.mark.parametrize("direction", ["Right", "Left"])
def test_truncation_then_padding_matches_the_library(tmp_path, direction):
    spec = write(tmp_path, "tp", truncation=trunc(6, direction), post="bert",
                 padding=pad({"Fixed": 9}, direction, 4))
    for text in TEXTS:
        got, want = both(spec, text)
        assert got == want, text


@pytest.mark.parametrize("bad", [{"truncation": trunc(5, "Middle")},
                                 {"truncation": trunc(5, strategy="Shortest")},
                                 {"padding": pad({"Fixed": 5}, "Up")},
                                 {"padding": pad("Longest")}])
def test_option_the_library_refuses_raises(tmp_path, bad):
    spec = write(tmp_path, "bad", **bad)
    with pytest.raises(Exception):
        jax_load(spec)
    with pytest.raises(ValueError):
        load_tokenizer(spec)
