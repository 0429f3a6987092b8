"""GGUF vocabularies through the port's tokenizer pipeline against the JAX
package's ``tokenizer_from_gguf`` (the ``tokenizers`` library), on the CPU.

Two GGUF files are written with tests/test_torch_gguf.py's writer from
models trained here: a ``gpt2`` vocabulary (tokens + merges of the GPT-2
family of tests/tokenizer_families.py, ``<|endoftext|>`` as bos/eos) and a
``llama`` vocabulary (a Unigram trained over Metaspace words, with
``<unk>`` / ``<s>`` / ``</s>`` and the 256 ``<0xNN>`` byte tokens first, as
SentencePiece llama files have them). For each, over 300 hypothesis texts
and the README paragraphs: encode ids, decode text with and without
``skip_special_tokens``, ``DecodeStream`` deltas, EOS ids and the
vocabulary size equal the JAX ``load_tokenizer({"type": "gguf"})``'s;
``add_bos_token`` defaults to true for the llama kind and false for gpt2,
and the metadata flag overrides both.
"""

from __future__ import annotations

import json
import random

import pytest
from hypothesis import HealthCheck, given, settings

from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from test_torch_gguf import _T_ARRAY, _T_F32, _T_STRING, _T_U32, write_gguf
from test_torch_tokenizer import TEXT, assert_same
from tokenizer_families import EXTRA, build, corpus, readme_paragraphs, token_json

BYTES = [f"<0x{b:02X}>" for b in range(256)]


def gpt2_meta(tmp_path) -> list[tuple]:
    spec = token_json(build("gpt2", tmp_path / "gpt2"))
    vocab = {**spec["model"]["vocab"], **{t["content"]: t["id"] for t in spec["added_tokens"]}}
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m) for m in spec["model"]["merges"]]
    eot = vocab["<|endoftext|>"]
    return [("tokenizer.ggml.model", _T_STRING, "gpt2"),
            ("tokenizer.ggml.tokens", _T_ARRAY, (_T_STRING, tokens)),
            ("tokenizer.ggml.merges", _T_ARRAY, (_T_STRING, merges)),
            ("tokenizer.ggml.bos_token_id", _T_U32, eot),
            ("tokenizer.ggml.eos_token_id", _T_U32, eot)]


def llama_meta() -> list[tuple]:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    tok.train_from_iterator(corpus(), trainers.UnigramTrainer(
        vocab_size=700, unk_token="<unk>", special_tokens=["<unk>"], show_progress=False))
    learned = [(p, s) for p, s in json.loads(tok.to_str())["model"]["vocab"]
               if p not in ("<unk>", "<s>", "</s>") and p not in BYTES]
    tokens = ["<unk>", "<s>", "</s>"] + BYTES + [p for p, _ in learned]
    scores = [0.0] * (3 + len(BYTES)) + [float(s) for _, s in learned]
    return [("tokenizer.ggml.model", _T_STRING, "llama"),
            ("tokenizer.ggml.tokens", _T_ARRAY, (_T_STRING, tokens)),
            ("tokenizer.ggml.scores", _T_ARRAY, (_T_F32, scores)),
            ("tokenizer.ggml.unknown_token_id", _T_U32, 0),
            ("tokenizer.ggml.bos_token_id", _T_U32, 1),
            ("tokenizer.ggml.eos_token_id", _T_U32, 2)]


@pytest.fixture(scope="module")
def vocabularies(tmp_path_factory):
    root = tmp_path_factory.mktemp("gguf_vocab")
    out = {}
    for kind, meta in (("gpt2", gpt2_meta(root)), ("llama", llama_meta())):
        path = str(root / f"{kind}.gguf")
        write_gguf(path, [("general.architecture", _T_STRING, "llama"), *meta], {})
        out[kind] = (path, meta)
    return out


def both(path: str):
    spec = {"type": "gguf", "path": path}
    return jax_load(spec), load_tokenizer(spec)


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_gguf_vocabulary_matches_the_jax_tokenizer(vocabularies, kind):
    jtok, ttok = both(vocabularies[kind][0])
    assert ttok.eos_token_ids == jtok.eos_token_ids
    assert ttok.vocab_size == jtok.vocab_size
    rng = random.Random(0)
    for text in readme_paragraphs() + EXTRA + ["<s>hi</s>", "<|endoftext|>x", "<0x41>"]:
        assert_same(jtok, ttok, text, rng)
    for _ in range(300):
        ids = [rng.randrange(jtok.vocab_size) for _ in range(rng.randint(1, 8))]
        for skip in (True, False):
            assert ttok.decode(ids, skip) == jtok.decode(ids, skip), ids

    @settings(max_examples=300, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(text=TEXT)
    def check(text):
        assert_same(jtok, ttok, text, random.Random(len(text)))

    check()


@pytest.mark.parametrize("kind, flag, bos", [("gpt2", None, False), ("gpt2", 1, True),
                                             ("llama", None, True), ("llama", 0, False)])
def test_add_bos_token_default_and_flag(vocabularies, tmp_path, kind, flag, bos):
    path, meta = vocabularies[kind]
    if flag is not None:
        path = str(tmp_path / "flag.gguf")
        write_gguf(path, [("general.architecture", _T_STRING, "llama"), *meta,
                          ("tokenizer.ggml.add_bos_token", _T_U32, flag)], {})
    jtok, ttok = both(path)
    ids = ttok.encode("hello world")
    assert ids == jtok.encode("hello world")
    bos_id = dict((k, v) for k, _, v in meta)["tokenizer.ggml.bos_token_id"]
    assert (ids[0] == bos_id) == bos
