"""The classes of ``Split`` patterns in the port (Oniguruma's, translated
for ``re`` by llm/unicode_classes.py) against the ``tokenizers``
library's, over every code point (surrogates aside) in order, one string
made once per module: ``\\w``, ``\\d``, ``\\s``, ``\\h``, ``\\b``, general
categories, ``\\p{Common}``, ``\\p{Inherited}``, ``\\p{Unknown}``,
``\\p{ASCII}``, a negated bracket class, and every script at once (each
an alternative of one pattern). A class shows as runs of code points in
and out of it.
"""

from __future__ import annotations

import pytest

from dynamo_tpu_torch.llm import unicode_scripts
from test_torch_tokenizer_pretokenizers import assert_same, code_points

CLASSES = [r"\w", r"\d", r"\s", r"\h", r"\b", r"\p{L}", r"\p{Lu}", r"\p{Ll}", r"\p{Lo}",
           r"\p{M}", r"\p{Mn}", r"\p{N}", r"\p{Nd}", r"\p{P}", r"\p{Po}", r"\p{S}", r"\p{So}",
           r"\p{Z}", r"\p{C}", r"\p{Cf}", r"\p{Cn}", r"\p{Common}", r"\p{Inherited}",
           r"\p{Unknown}", r"\p{ASCII}", r"[^\p{L}\d]"]


@pytest.fixture(scope="module")
def every_code_point() -> dict[str, str]:
    return {"alone": "".join(map(chr, code_points()))}


@pytest.mark.parametrize("cls", CLASSES)
def test_pattern_class_matches_the_library(every_code_point, cls):
    assert_same({"type": "Split", "pattern": {"Regex": cls + ("" if cls[1] in "bB" else "+")},
                 "behavior": "Isolated", "invert": False}, every_code_point)


def test_every_script_class_in_one_pattern(every_code_point):
    """Runs of each script (one alternative each) over every code point."""
    pattern = "|".join(r"\p{%s}+" % names[0] for names in unicode_scripts.NAMES)
    assert_same({"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
                 "invert": False}, every_code_point)
