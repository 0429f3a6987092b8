"""Small tokenizer.json files of more published kinds, trained here.

``build`` trains a small vocabulary with the ``tokenizers`` package (a
test dependency; the port never imports it) on the component set of one
published tokenizer, written out below from its published file, and
writes ``tokenizer.json`` into a directory:

- ``bert``: bert-base-uncased — BertNormalizer (lowercase),
  BertPreTokenizer, WordPiece (``[UNK]``, ``##``), TemplateProcessing
  ``[CLS] $A [SEP]`` with its pair template, the WordPiece decoder.
- ``roberta``: roberta-base — ByteLevel without a prefix space, BPE,
  RobertaProcessing, the ByteLevel decoder.
- ``clip``: clip-vit-base-patch32 — NFC, Replace(\\s+ → " ") and Lowercase;
  Split (CLIP's pattern, Removed, inverted) then ByteLevel without its
  regex; BPE with ``end_of_word_suffix`` ``</w>``; BPEDecoder;
  RobertaProcessing.
- ``falcon``: falcon-7b — Punctuation, ByteLevel and Digits in one
  Sequence, BPE, the ByteLevel decoder.
- ``starcoder``: starcoder — Digits(individual_digits) then ByteLevel,
  BPE, the ByteLevel decoder.
- ``xlmr``: xlm-roberta-base / t5-small — Precompiled (a charsmap from
  ``chip_smoke.xlmr_charsmap``) then Replace(" {2,}" → " "),
  WhitespaceSplit then Metaspace, Unigram, TemplateProcessing
  ``<s> $A </s>``, the Metaspace decoder.
- ``wordlevel``: WordLevel with Whitespace; ``wordlevel_ctc`` the same
  with a CTC decoder.

The trainers see ``CORPUS``, a fixed text written here (and
tests/tokenizer_families.py's ``EXTRA``), never the repository's
Markdown, whose wording changes.
"""

from __future__ import annotations

import json
from pathlib import Path

from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers

from tokenizer_families import EXTRA

KINDS = ("bert", "roberta", "clip", "falcon", "starcoder", "xlmr", "wordlevel", "wordlevel_ctc")

CORPUS = EXTRA + [
    "The quick brown fox jumps over the lazy dog. Don't you think it's nice?",
    "Tokenizers split text into words, then words into pieces that a model knows.",
    "Serving many requests at once needs a scheduler, a cache of keys and values, and care.",
    "Unicode holds letters, marks, numbers, punctuation, symbols and separators.",
    "Café résumé naïve coöperate façade — piñata jalapeño über straße",
    "数字 123 和 ４５６ 以及 ٧٨٩ and ⅻ ½ ² are numbers of several kinds.",
    "[CLS] [SEP] [MASK] <s> </s> <pad> <unk> <|endoftext|> are special tokens.",
    "She said: «Bonjour!» He answered: “Hello!” They left; we stayed…",
    "def tokenize(text: str) -> list[int]:\n    return [ord(c) for c in text]\n",
    "ΑΣ İstanbul ẞtraße ǅemal  multiple   spaces\tand\ttabs\nnewlines",
]


def corpus() -> list[str]:
    return CORPUS * 30


def _write(path: Path, tok: Tokenizer, edit=None) -> str:
    path.mkdir(parents=True, exist_ok=True)
    spec = json.loads(tok.to_str())
    if edit is not None:
        edit(spec)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return str(path)


def _bpe(tok: Tokenizer, vocab_size: int, special=(), **kw) -> None:
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(special), show_progress=False, **kw))


def build(kind: str, path: Path, vocab_size: int = 800) -> str:
    """Train ``kind``'s tokenizer and write it under ``path`` → path."""
    byte_alphabet = pre_tokenizers.ByteLevel.alphabet()
    if kind == "bert":
        tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
        tok.normalizer = normalizers.BertNormalizer(lowercase=True)
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        tok.train_from_iterator(corpus(), trainers.WordPieceTrainer(
            vocab_size=vocab_size, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
            show_progress=False))
        cls, sep = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
        tok.decoder = decoders.WordPiece(prefix="##", cleanup=True)
        return _write(path, tok)
    if kind == "roberta":
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        _bpe(tok, vocab_size, ["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
             initial_alphabet=byte_alphabet)
        tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0),
                                                          trim_offsets=True,
                                                          add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        return _write(path, tok)
    if kind == "clip":
        tok = Tokenizer(models.BPE(unk_token="<|endoftext|>", end_of_word_suffix="</w>",
                                   continuing_subword_prefix=""))
        tok.normalizer = normalizers.Sequence([normalizers.NFC(),
                                               normalizers.Replace(Regex(r"\s+"), " "),
                                               normalizers.Lowercase()])
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"
                                       r"[^\s\p{L}\p{N}]+"), behavior="removed", invert=True),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        _bpe(tok, vocab_size, ["<|startoftext|>", "<|endoftext|>"],
             initial_alphabet=byte_alphabet, end_of_word_suffix="</w>")
        start, end = tok.token_to_id("<|startoftext|>"), tok.token_to_id("<|endoftext|>")
        tok.post_processor = processors.RobertaProcessing(("<|endoftext|>", end),
                                                          ("<|startoftext|>", start))
        tok.decoder = decoders.BPEDecoder(suffix="</w>")
        return _write(path, tok)
    if kind in ("falcon", "starcoder"):
        tok = Tokenizer(models.BPE())
        if kind == "falcon":
            tok.pre_tokenizer = pre_tokenizers.Sequence([
                pre_tokenizers.Punctuation("contiguous"),
                pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
                pre_tokenizers.Digits(individual_digits=False)])
            special = [">>TITLE<<", ">>ABSTRACT<<", ">>COMMENT<<", "<|endoftext|>"]
        else:
            tok.pre_tokenizer = pre_tokenizers.Sequence([
                pre_tokenizers.Digits(individual_digits=True),
                pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)])
            special = ["<|endoftext|>", "<fim_prefix>", "<fim_middle>", "<fim_suffix>"]
        _bpe(tok, vocab_size, special, initial_alphabet=byte_alphabet)
        tok.decoder = decoders.ByteLevel()
        return _write(path, tok)
    if kind == "xlmr":
        import chip_smoke

        tok = Tokenizer(models.Unigram())
        tok.normalizer = normalizers.Sequence([
            normalizers.Precompiled(chip_smoke.xlmr_charsmap()),
            normalizers.Replace(Regex(" {2,}"), " ")])
        tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                     pre_tokenizers.Metaspace()])
        tok.train_from_iterator(corpus(), trainers.UnigramTrainer(
            vocab_size=vocab_size, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
            unk_token="<unk>", show_progress=False))
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
            special_tokens=[("<s>", tok.token_to_id("<s>")), ("</s>", tok.token_to_id("</s>"))])
        tok.decoder = decoders.Metaspace()
        return _write(path, tok)
    if kind in ("wordlevel", "wordlevel_ctc"):
        tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        tok.train_from_iterator(corpus(), trainers.WordLevelTrainer(
            vocab_size=vocab_size, special_tokens=["<pad>", "<unk>", "|"], show_progress=False))
        if kind == "wordlevel_ctc":
            tok.decoder = decoders.CTC(pad_token="<pad>", word_delimiter_token="|", cleanup=True)
        return _write(path, tok)
    raise ValueError(kind)
