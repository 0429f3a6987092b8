"""The port's pure-Python tokenizer.json pipeline against the JAX package's
``load_tokenizer`` (the ``tokenizers`` library), on the CPU.

Four families are trained here with their published component sets
(tests/tokenizer_families.py: Llama-3.1, Qwen2, the llama-2
SentencePiece-BPE kind, GPT-2). For each, over 300 hypothesis texts
(emoji, combining marks, CJK, control characters, added tokens mid-text)
and every README paragraph: encode ids, decode text with and without
``skip_special_tokens``, ``DecodeStream`` step / step_many / flush deltas,
``eos_token_ids`` and the vocabulary size must be equal. Lossy UTF-8 decode
(one U+FFFD per maximal invalid subpart, which ``DecodeStream`` keys on)
is held against the library over random bytes.

The exhaustive sweep: for the Llama-3, Qwen2 and GPT-2 pre-tokenizers, the
port's split equals the library's for every code point c of the BMP and
planes 1–2 that is assigned (in this interpreter's ``unicodedata``, or
among the newer letters and numbers the port adds), embedded as
``"a" + c + "1 " + c + "\\n"`` and as ``"x'" + c + "l "`` (the
case-insensitive contractions). Left out: the surrogates U+D800–U+DFFF
(no UTF-8 string holds one) and unassigned code points.
"""

from __future__ import annotations

import json
import random
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.tokenizer import DecodeStream as JDecodeStream
from dynamo_tpu.llm.tokenizer import HFTokenizer as JHF
from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load
from dynamo_tpu_torch.llm import unicode_classes as U
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer, load_tokenizer
from dynamo_tpu_torch.llm.tokenizer import parse_tokenizer_spec, tokenizer_spec_for
from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson
from tokenizer_families import EXTRA, FAMILIES, LLAMA3_SPECIALS, build, readme_paragraphs

MARKERS = (LLAMA3_SPECIALS[:12] + ["<s>", "</s>", "<unk>", "<|endoftext|>", "<|im_start|>",
                                   "<|im_end|>", "<0x41>"])
PIECES = ["😀", "👨‍👩‍👧", "👍🏽", "🇫🇷", "é", "é", "ñ", "中文", "日本", "한국", "\x1c", "\x1f",
          "\r\n", "\n\n", "  ", "\t", "'s", "'LL", "'ſ", "ﬆ", "̀", "¿", "…", "١٢٣", "12345",
          " ", "\xa0", "　", "\U0002EBF0", "\U00010D40"]
TEXT = st.lists(st.one_of(
    st.text(st.characters(blacklist_categories=("Cs",)), max_size=10),
    st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E), max_size=16),
    st.sampled_from(MARKERS), st.sampled_from(PIECES)), max_size=10).map("".join)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    out = {}
    for fam in FAMILIES:
        path = build(fam, root / fam)
        out[fam] = (jax_load({"type": "hf", "path": path}), load_tokenizer({"type": "hf",
                                                                            "path": path}), path)
    return out


def stream_deltas(make, tok, ids, chunks):
    """DecodeStream deltas: per token, then per chunk (step_many), then flush."""
    ds = make(tok)
    one = [ds.step(t) for t in ids] + [ds.flush()]
    ds = make(tok)
    many, i = [], 0
    for n in chunks:
        many.append(ds.step_many(ids[i:i + n]))
        i += n
    many += [ds.step_many(ids[i:]), ds.flush()]
    return one, many


def assert_same(jtok, ttok, text: str, rng: random.Random) -> None:
    ids = jtok.encode(text)
    assert ttok.encode(text) == ids, text
    for skip in (True, False):
        assert ttok.decode(ids, skip) == jtok.decode(ids, skip), (text, skip)
    chunks = [rng.randint(1, 5) for _ in range(len(ids) // 2)]
    assert (stream_deltas(DecodeStream, ttok, ids, chunks)
            == stream_deltas(JDecodeStream, jtok, ids, chunks)), text


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_the_jax_tokenizer(families, family):
    jtok, ttok, _ = families[family]
    assert ttok.eos_token_ids == jtok.eos_token_ids
    assert ttok.vocab_size == jtok.vocab_size
    rng = random.Random(0)
    for text in readme_paragraphs() + EXTRA + ["", " ", "<|begin_of_text|>"]:
        assert_same(jtok, ttok, text, rng)
    # Ids the encoder never emits decode the same too (specials, bytes).
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


@settings(max_examples=300, deadline=None, derandomize=True)
@given(data=st.binary(max_size=24))
def test_lossy_utf8_decode_matches_the_library(data):
    """ByteLevel tokens of arbitrary bytes: one U+FFFD per maximal invalid
    subpart, as the library's from_utf8_lossy."""
    from tokenizers import decoders

    from dynamo_tpu_torch.llm.tokenizer_json import _BYTE_CHAR, _byte_fallback

    tokens = [_BYTE_CHAR[b] for b in data]
    port = TokenizerJson({"model": {"type": "BPE", "vocab": {}, "merges": []},
                          "decoder": {"type": "ByteLevel"}})
    assert "".join(port.decoder(tokens)) == decoders.ByteLevel().decode(tokens)
    fallback = [f"<0x{b:02X}>" for b in data]
    assert "".join(_byte_fallback(fallback)) == decoders.ByteFallback().decode(fallback)


def sweep_code_points() -> list[int]:
    newer = {c for a, b in U._NEWER_L + U._NEWER_N for c in range(a, b + 1)}
    return [c for c in range(0x30000) if not 0xD800 <= c <= 0xDFFF
            and (unicodedata.category(chr(c)) != "Cn" or c in newer)]


@pytest.mark.parametrize("family", ["llama3", "qwen2", "gpt2"])
def test_pre_tokenizer_split_sweep(families, family):
    path = families[family][2]
    lib = JHF(path)._tok
    port = TokenizerJson.from_file(f"{path}/tokenizer.json")
    norm = lib.normalizer
    bad = []
    for c in sweep_code_points():
        ch = chr(c)
        for text in ("a" + ch + "1 " + ch + "\n", "x'" + ch + "l "):
            want = [p for p, _ in lib.pre_tokenizer.pre_tokenize_str(
                norm.normalize_str(text) if norm is not None else text)]
            got = [p for p, _ in port.pre_tokenize(
                [(port.normalize(text) if port.normalize else text, True)])]
            if got != want:
                bad.append(hex(c))
    assert bad == []


def test_unicode_classes():
    ws = {c for a, b in U.class_ranges("White_Space") for c in range(a, b + 1)}
    assert len(ws) == 25 and not ws & {0x1C, 0x1D, 0x1E, 0x1F}
    letters = {c for a, b in U.class_ranges("L") for c in range(a, b + 1)}
    assert all(unicodedata.category(chr(c))[0] == "L" for c in letters if c < 0x1C89)
    assert 0x2EBF0 in letters and 0x10D40 in {c for a, b in U.class_ranges("N")
                                             for c in range(a, b + 1)}
    for bad in (r"\X", r"\p{Emoji}", r"[[a-z]&&[^x]]"):
        with pytest.raises(NotImplementedError):
            U.translate(bad)


@pytest.mark.parametrize("component, spec", [
    ("normalizer", {"type": "NFKX"}),
    ("pre_tokenizer", {"type": "Digitz", "individual_digits": True}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"String": " "}, "behavior": "Dropped",
                       "invert": False}),
    ("post_processor", {"type": "BertProcessor", "sep": ["[SEP]", 1], "cls": ["[CLS]", 0]}),
    ("decoder", {"type": "WordPieces", "prefix": "##", "cleanup": True}),
    ("model", {"type": "WordPieces", "vocab": {"a": 0}, "unk_token": "a"}),
])
def test_unported_components_raise_naming_the_type(component, spec):
    """Every type the library defines is ported; one it does not define
    (nor any option value it does not define) fails to load, named."""
    base = {"model": {"type": "BPE", "vocab": {"a": 0}, "merges": []}}
    with pytest.raises(ValueError, match=spec.get("behavior") or spec["type"]):
        TokenizerJson({**base, component: spec})


def test_added_token_flags_match_the_library(tmp_path):
    """lstrip / rstrip / single_word and normalized added tokens (beyond
    what the published files set) on the GPT-2 family."""
    from tokenizers import AddedToken, Tokenizer

    path = build("gpt2", tmp_path / "gpt2")
    lib = Tokenizer.from_file(f"{path}/tokenizer.json")
    lib.add_tokens([AddedToken(" zz", lstrip=True, rstrip=True),
                    AddedToken("word", single_word=True), AddedToken("é<x>")])
    lib.add_special_tokens([AddedToken("<mask>", lstrip=True, special=True)])
    (tmp_path / "flags").mkdir()
    lib.save(str(tmp_path / "flags" / "tokenizer.json"))
    spec = json.loads((tmp_path / "flags" / "tokenizer.json").read_text())
    assert {t["content"] for t in spec["added_tokens"]} >= {" zz", "word", "é<x>", "<mask>"}
    jtok = jax_load({"type": "hf", "path": str(tmp_path / "flags")})
    ttok = load_tokenizer({"type": "hf", "path": str(tmp_path / "flags")})
    rng = random.Random(1)
    for text in ["a  zz  b", "words word _word word_ aword. word", "x é<x>y", "p   <mask>q",
                 " zz zz  zz", "<mask><mask> zz"]:
        assert_same(jtok, ttok, text, rng)


def test_specs_and_loading(families, tmp_path):
    """Spec parsing and the CLIs' choice; a JAX model card's hf spec loads
    in the port."""
    path = families["llama3"][2]
    assert parse_tokenizer_spec("byte") == {"type": "byte"}
    assert parse_tokenizer_spec(f"hf:{path}") == {"type": "hf", "path": path}
    assert parse_tokenizer_spec("gguf:/x.gguf") == {"type": "gguf", "path": "/x.gguf"}
    assert tokenizer_spec_for(None, None) == {"type": "byte"}
    assert tokenizer_spec_for(path, None) == {"type": "hf", "path": path}
    assert tokenizer_spec_for(path, "byte") == {"type": "byte"}
    gguf = tmp_path / "m.gguf"
    gguf.write_bytes(b"GGUF" + bytes(20))
    assert tokenizer_spec_for(str(gguf), None) == {"type": "gguf", "path": str(gguf)}
    tok = HFTokenizer(f"{path}/tokenizer.json")  # a file path: no generation_config beside
    assert tok.encode("<|begin_of_text|>hi")[:2] == [tok._tok.token_to_id("<|begin_of_text|>")] * 2
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard

    card = TCard.from_dict(JCard(name="m", tokenizer={"type": "hf", "path": path}).to_dict())
    assert load_tokenizer(card.tokenizer).encode("hello") == families["llama3"][0].encode("hello")
