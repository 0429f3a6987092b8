"""chip_smoke.py's phase-9 family sub-check, rehearsed on the CPU.

``chip_smoke.tok_family_check`` writes the bert, falcon, clip and xlmr
kinds from its recipes (a fixed corpus and a seeded fill, no tokenizers
library), loads each with the port's ``load_tokenizer`` and hashes what it
makes of ``TOK_FAMILY_TEXTS`` (ids, decodes, ``DecodeStream`` deltas,
vocabulary size, EOS). Here:

- at reduced sizes, the sub-check runs against digests computed through
  the JAX package's ``load_tokenizer`` (the library) on the same files;
- at the published sizes, ``TOK_FAMILY_DIGESTS`` (which the card holds
  the port to, with no library there) equals the library's digests, and
  the port's sub-check passes against it;
- the files are the published kinds: vocabulary sizes, specials and
  component types.
"""

from __future__ import annotations

import json

import pytest

import chip_smoke as C
from dynamo_tpu.llm.tokenizer import DecodeStream as JDecodeStream
from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load

REDUCED = {"bert": 2_000, "falcon": 3_000, "clip": 3_000, "xlmr": 5_000}


def library_digests(root, sizes: dict) -> dict:
    out = {}
    for fam, n in sizes.items():
        path = C.write_family_tokenizer(fam, str(root / fam), n)
        out[fam] = C.family_digest(C.family_outputs(jax_load({"type": "hf", "path": path}),
                                                    JDecodeStream))
    return out


def test_sub_check_at_reduced_sizes_matches_the_library(tmp_path):
    digests = library_digests(tmp_path / "lib", REDUCED)
    res = C.tok_family_check("CPU", str(tmp_path / "port"), sizes=REDUCED, digests=digests)
    assert {f: r["digest"] for f, r in res.items()} == digests
    for r in res.values():
        assert r["load_s"] > 0 and r["encode_us_per_token"] > 0
        assert r["decode_stream_us_per_token"] > 0 and r["tokens"] > 100
    assert not (tmp_path / "port").exists()  # the sub-check cleans up


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = tmp_path_factory.mktemp("published")
    return root, library_digests(root, C.TOK_FAMILY_SIZES)


def test_family_digests_constant_is_the_librarys(published):
    assert published[1] == C.TOK_FAMILY_DIGESTS


def test_sub_check_at_published_sizes_passes(tmp_path):
    res = C.tok_family_check("CPU", str(tmp_path / "port"))
    assert {f: r["ids"] for f, r in res.items()} == C.TOK_FAMILY_SIZES


def test_family_files_are_the_published_kinds(published):
    root, _ = published
    spec = {f: json.loads((root / f / "tokenizer.json").read_text(encoding="utf-8"))
            for f in C.TOK_FAMILY_SIZES}
    for f, n in C.TOK_FAMILY_SIZES.items():
        assert jax_load({"type": "hf", "path": str(root / f)}).vocab_size == n
    bert = spec["bert"]
    assert (bert["normalizer"]["type"], bert["pre_tokenizer"]["type"], bert["model"]["type"],
            bert["decoder"]["type"]) == ("BertNormalizer", "BertPreTokenizer", "WordPiece",
                                         "WordPiece")
    assert bert["model"]["vocab"]["[CLS]"] == 101 and bert["model"]["vocab"]["[MASK]"] == 103
    assert [p["type"] for p in spec["falcon"]["pre_tokenizer"]["pretokenizers"]] == [
        "Punctuation", "ByteLevel", "Digits"]
    clip = spec["clip"]
    assert clip["model"]["end_of_word_suffix"] == "</w>"
    assert clip["decoder"]["type"] == "BPEDecoder"
    assert clip["post_processor"]["type"] == "RobertaProcessing"
    xlmr = spec["xlmr"]
    assert [n["type"] for n in xlmr["normalizer"]["normalizers"]] == ["Precompiled", "Replace"]
    assert xlmr["model"]["type"] == "Unigram" and xlmr["model"]["unk_id"] == 3
    assert xlmr["model"]["vocab"][-1][0] == "<mask>"
