"""The port's tokenizer against the JAX package's (the ``tokenizers``
library) on more published kinds, end to end, on the CPU.

Each kind of tests/torch_tokenizer_kinds.py (bert, roberta, clip, falcon,
starcoder, xlmr, wordlevel and a CTC-decoded wordlevel) is trained here
and loaded by both packages' ``load_tokenizer``. Over the training lines
and 150 hypothesis texts (emoji, combining marks, CJK, control
characters, added tokens mid-text): encode ids, decode with and without
``skip_special_tokens``, ``DecodeStream`` step / step_many / flush deltas;
and ``vocab_size``, ``eos_token_ids`` and ``grammar_vocab`` (every id's
bytes) must be equal.
"""

from __future__ import annotations

import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.grammar import grammar_vocab as jax_grammar_vocab
from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load
from dynamo_tpu_torch.engine.grammar import grammar_vocab
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from test_torch_tokenizer import PIECES, assert_same
from torch_tokenizer_kinds import CORPUS, KINDS, build

MARKERS = ["[CLS]", "[SEP]", "[MASK]", "[UNK]", "[PAD]", "<s>", "</s>", "<pad>", "<unk>",
           "<mask>", "<|endoftext|>", "<|startoftext|>", ">>TITLE<<", "<fim_prefix>", "|",
           "</w>", "▁", "##"]
TEXT = st.lists(st.one_of(
    st.text(st.characters(blacklist_categories=("Cs",)), max_size=10),
    st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E), max_size=16),
    st.sampled_from(MARKERS), st.sampled_from(PIECES)), max_size=10).map("".join)


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    root = tmp_path_factory.mktemp("kinds")
    out = {}
    for kind in KINDS:
        path = build(kind, root / kind)
        spec = {"type": "hf", "path": path}
        out[kind] = (jax_load(spec), load_tokenizer(spec))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_the_jax_tokenizer(kinds, kind):
    jtok, ttok = kinds[kind]
    assert ttok.vocab_size == jtok.vocab_size
    assert ttok.eos_token_ids == jtok.eos_token_ids
    rng = random.Random(0)
    for text in CORPUS + ["", " ", "  ", "\n", "[CLS]", "<s>x</s>"]:
        assert_same(jtok, ttok, text, rng)
    for _ in range(300):
        ids = [rng.randrange(jtok.vocab_size) for _ in range(rng.randint(1, 8))]
        for skip in (True, False):
            assert ttok.decode(ids, skip) == jtok.decode(ids, skip), ids

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(text=TEXT)
    def check(text):
        assert_same(jtok, ttok, text, random.Random(len(text)))

    check()


@pytest.mark.parametrize("kind", KINDS)
def test_kind_grammar_vocab_matches(kinds, kind):
    jtok, ttok = kinds[kind]
    assert grammar_vocab(ttok) == jax_grammar_vocab(jtok)
