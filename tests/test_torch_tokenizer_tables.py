"""The port's committed Unicode tables, regenerated from the ``tokenizers``
library (and the ``regex`` module for scripts and grapheme breaks) by
tests/torch_unicode_tables.py, equal those in dynamo_tpu_torch/llm/
unicode_tables.py and unicode_scripts.py.

Each table sweeps every code point (surrogates aside) through the library:
Oniguruma's general categories, ``\\w`` and ``\\s``; the ``Whitespace``
pre-tokenizer's ``\\w``; Rust's ``is_whitespace`` and ``is_numeric``; the
punctuation of ``Punctuation``; ``BertNormalizer``'s control, Chinese and
accent tables; ``StripAccents``' marks; ``Lowercase``; the code points the
library's normalisation forms do not know; the scripts of ``\\p{..}`` and
of ``UnicodeScripts``; Grapheme_Cluster_Break, Extended_Pictographic and
Indic_Conjunct_Break. About 45 s in all.
"""

from __future__ import annotations

import pytest

import torch_unicode_tables as G
from dynamo_tpu_torch.llm import unicode_classes as U
from dynamo_tpu_torch.llm import unicode_scripts, unicode_tables

GENERATED = G.TABLES


def test_every_table_is_regenerated():
    committed = {k for k in dir(unicode_tables) if k.isupper()}
    assert committed == set(GENERATED) | {"GRAPHEME_CLUSTER_BREAK", "EXTENDED_PICTOGRAPHIC",
                                          "INDIC_CONJUNCT_BREAK"}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_table_equals_the_library(name):
    assert GENERATED[name]() == getattr(unicode_tables, name)


def test_oniguruma_white_space_is_rust_white_space():
    assert G.ranges(G._split(r"\s")) == unicode_tables.WHITE_SPACE == U.class_ranges("White_Space")


@pytest.fixture(scope="module")
def scripts():
    return G.onig_scripts()


def test_scripts_equal_oniguruma(scripts):
    assert scripts["names"] == unicode_scripts.NAMES
    assert scripts["ranges"] == unicode_scripts.RANGES


def test_unicode_scripts_classes_equal_the_library(scripts):
    assert G.unicode_scripts_classes(scripts) == unicode_scripts.UNICODE_SCRIPTS


def test_grapheme_breaks_equal_the_regex_module():
    got = G.grapheme_breaks(G.unknown_code_points())
    assert got["gcb"] == unicode_tables.GRAPHEME_CLUSTER_BREAK
    assert got["pict"] == unicode_tables.EXTENDED_PICTOGRAPHIC
    assert got["incb"] == unicode_tables.INDIC_CONJUNCT_BREAK


def test_rendered_modules_are_the_committed_files(scripts):
    """The files are exactly what the generator writes (nothing edited by
    hand)."""
    tables = {k: getattr(unicode_tables, k) for k in GENERATED}
    graphemes = {"gcb": unicode_tables.GRAPHEME_CLUSTER_BREAK,
                 "pict": unicode_tables.EXTENDED_PICTOGRAPHIC,
                 "incb": unicode_tables.INDIC_CONJUNCT_BREAK}
    assert G.render_tables(tables, graphemes) == (G.LLM / "unicode_tables.py").read_text(
        encoding="utf-8")
    assert G.render_scripts(scripts, unicode_scripts.UNICODE_SCRIPTS) == (
        G.LLM / "unicode_scripts.py").read_text(encoding="utf-8")
