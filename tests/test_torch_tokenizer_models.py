"""Each model of the port's tokenizer.json pipeline against the
``tokenizers`` library's own (``model.tokenize`` ids), on the CPU.

``WordPiece`` and ``WordLevel`` come from the trained bert and wordlevel
kinds (tests/torch_tokenizer_kinds.py), BPE with
``continuing_subword_prefix`` and ``end_of_word_suffix`` is trained here;
each runs over the words the library's pre-tokenizer makes of the corpus
and over hypothesis words, with its options varied. BPE ``dropout`` draws
from the library's thread RNG, so it is held by properties: at 1.0 (every
merge skipped) the ids equal the library's; at any rate the tokens spell
the word; the same seed gives the same ids; the per-word cache is
bypassed.
"""

from __future__ import annotations

import json
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer, models, pre_tokenizers, trainers

from dynamo_tpu_torch.llm.tok_models import model
from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson
from torch_tokenizer_kinds import CORPUS, build, corpus

WORD = st.text(st.characters(blacklist_categories=("Cs", "Zs")), min_size=1, max_size=14)


def library_model(spec: dict):
    base = json.loads(Tokenizer(models.BPE()).to_str())
    base["model"] = spec
    return Tokenizer.from_str(json.dumps(base)).model


def lib_ids(lib, word: str) -> list[int]:
    return [t.id for t in lib.tokenize(word)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    out = {}
    for kind in ("bert", "wordlevel"):
        with open(f"{build(kind, root / kind)}/tokenizer.json", encoding="utf-8") as f:
            out[kind] = json.load(f)
    tok = Tokenizer(models.BPE(continuing_subword_prefix="##", end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=700, continuing_subword_prefix="##", end_of_word_suffix="</w>",
        special_tokens=["<unk>"], show_progress=False))
    out["bpe"] = json.loads(tok.to_str())
    return out


def words(spec: dict) -> list[str]:
    pre = Tokenizer.from_str(json.dumps(spec)).pre_tokenizer
    norm = Tokenizer.from_str(json.dumps(spec)).normalizer
    out = []
    for text in CORPUS + ["supercalifragilistic", "ab", "a", "日本語", "x" * 120]:
        text = norm.normalize_str(text) if norm is not None else text
        out += [w for w, _ in pre.pre_tokenize_str(text)]
    return out


def assert_same(spec: dict, texts: list[str]) -> None:
    port, lib = model(spec), library_model(spec)
    for w in texts:
        assert port.tokenize(w) == lib_ids(lib, w), (spec.get("type"), w)

    @settings(max_examples=200, deadline=None, derandomize=True)
    @given(w=WORD)
    def check(w):
        assert port.tokenize(w) == lib_ids(lib, w), w

    check()


@pytest.mark.parametrize("options", [{}, {"max_input_chars_per_word": 4},
                                     {"continuing_subword_prefix": "@@"},
                                     {"unk_token": "[MASK]"}])
def test_wordpiece_matches_the_library(trained, options):
    spec = {**trained["bert"]["model"], **options}
    assert_same(spec, words(trained["bert"]))


@pytest.mark.parametrize("options", [{}, {"unk_token": "|"}])
def test_wordlevel_matches_the_library(trained, options):
    spec = {**trained["wordlevel"]["model"], **options}
    assert_same(spec, words(trained["wordlevel"]))


@pytest.mark.parametrize("kind", ["WordPiece", "WordLevel"])
def test_missing_unk_token_raises_as_the_library(kind):
    spec = {"type": kind, "vocab": {"a": 0, "b": 1}, "unk_token": "[UNK]"}
    with pytest.raises(Exception):
        lib_ids(library_model(spec), "c")
    with pytest.raises(ValueError):
        model(spec).tokenize("c")


@pytest.mark.parametrize("options", [
    {}, {"end_of_word_suffix": None}, {"byte_fallback": True}, {"fuse_unk": True},
    {"ignore_merges": True}, {"dropout": 0.0}])
def test_bpe_prefix_and_suffix_match_the_library(trained, options):
    spec = {**trained["bpe"]["model"], "unk_token": "<unk>", **options}
    if options.get("byte_fallback"):
        vocab = dict(spec["vocab"])
        for b in range(256):
            vocab.setdefault(f"<0x{b:02X}>", len(vocab))
        spec["vocab"] = vocab
    if "end_of_word_suffix" in options:  # merges that name the suffix go with it
        spec["merges"] = [m for m in spec["merges"] if "</w>" not in "".join(m)]
    assert_same(spec, words(trained["bpe"]))


def test_bpe_dropout_one_skips_every_merge_as_the_library(trained):
    spec = {**trained["bpe"]["model"], "unk_token": "<unk>", "dropout": 1.0}
    assert_same(spec, words(trained["bpe"]))


def test_bpe_dropout_properties(trained):
    spec = {**trained["bpe"]["model"], "unk_token": "<unk>"}
    plain = model(spec)
    names = plain.id_to_token()

    def spell(ids):
        return "".join(names[i].replace("##", "").replace("</w>", "") for i in ids)

    unk = plain.token_to_id("<unk>")
    texts = [w for w in words(trained["bpe"]) if len(w) > 3 and unk not in plain.tokenize(w)]
    seen: dict[str, set] = {}
    for seed in (1, 2):
        runs = []
        for _ in range(2):
            drop = model({**spec, "dropout": 0.4}, random.Random(seed))
            runs.append([drop.tokenize(w) for w in texts])
        assert runs[0] == runs[1]  # the same seed, the same ids
        for w, ids in zip(texts, runs[0]):
            assert spell(ids) == spell(plain.tokenize(w)) == w
            seen.setdefault(w, set()).add(tuple(ids))
    assert any(len(v) > 1 for v in seen.values())  # the draws change the merges
    drop = model({**spec, "dropout": 0.4})
    long = max((w for w in texts if len(plain.tokenize(w)) < len(w) - 2), key=len)
    assert len({tuple(drop.tokenize(long)) for _ in range(20)}) > 1  # no cache
    assert drop._cache == {}
    full = {"model": {**spec, "dropout": 0.4}}
    assert (TokenizerJson(full).encode("hello worlds")
            == TokenizerJson(full).encode("hello worlds"))  # seed 0 by default


def test_bpe_dropout_out_of_range_raises_as_the_library(trained):
    spec = {**trained["bpe"]["model"], "dropout": 1.5}
    with pytest.raises(Exception):
        library_model(spec)
    with pytest.raises(ValueError):
        model(spec)
