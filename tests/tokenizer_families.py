"""Small tokenizer.json files of the published families, trained here.

``build`` trains a small vocabulary with the ``tokenizers`` package (a
test dependency; the port never imports it) using the component set of one
published tokenizer, and writes ``tokenizer.json`` (plus a
``generation_config.json`` where the family has one) into a directory:

- ``llama3``: Meta-Llama-3.1-8B — Split (Llama-3 pattern, Isolated) then
  ByteLevel without its regex, BPE with ``ignore_merges``, 256 added
  specials after the vocabulary, a TemplateProcessing BOS.
- ``qwen2``: Qwen2-7B — NFC, Split (Qwen2 pattern) then ByteLevel, BPE,
  ``<|endoftext|>`` / ``<|im_start|>`` / ``<|im_end|>``, no BOS.
- ``llama2``: TinyLlama-1.1B / Mistral-7B-v0.1 — Prepend(▁) + Replace(" "
  → ▁), no pre-tokenizer, BPE with ``byte_fallback``, ``fuse_unk`` and
  ``<unk>``, ``<0xNN>`` at ids 3–258, the Replace/ByteFallback/Fuse/Strip
  decoder, a TemplateProcessing ``<s>``.
- ``gpt2``: GPT-2 — ByteLevel with the GPT-2 regex, BPE,
  ``<|endoftext|>`` (normalized), ByteLevel post-processor and decoder.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers

REPO = Path(__file__).resolve().parents[1]

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])
FAMILIES = ("llama3", "qwen2", "llama2", "gpt2")

# Text the trainers see besides the repository's Markdown, so that merges
# cover more than ASCII.
EXTRA = ["héllo wörld, ça va? naïve café — «quotes» ‘single’ “double”",
         "日本語のテキストと中文文本，한국어 텍스트도 있습니다。",
         "Привет, как дела? Γειά σου κόσμε! שלום עולם مرحبا بالعالم",
         "emoji 😀🎉👍🏽 👨‍👩‍👧 flags 🇫🇷 and ∑∫√∞ math ±×÷",
         "numbers 1234567 3.14159 2025-10-17 0xDEADBEEF 1,000,000",
         "code: def f(x):\n    return x**2  # comment\n\tif a != b: pass\r\n"]


def corpus() -> list[str]:
    """The repository's README and SURVEY paragraphs, plus ``EXTRA``."""
    paras = []
    for name in ("README.md", "SURVEY.md"):
        text = (REPO / name).read_text(encoding="utf-8")
        paras += [p for p in text.split("\n\n") if p.strip()]
    return paras + EXTRA * 20


def readme_paragraphs() -> list[str]:
    text = (REPO / "README.md").read_text(encoding="utf-8")
    return [p for p in text.split("\n\n") if p.strip()]


def _train(tok: Tokenizer, vocab_size: int, special=(), alphabet=()) -> Tokenizer:
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(special), initial_alphabet=list(alphabet),
        show_progress=False))
    return tok


def _write(path: Path, spec: dict, generation: dict | None = None) -> str:
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    if generation is not None:
        (path / "generation_config.json").write_text(json.dumps(generation))
    return str(path)


def build(family: str, path: Path, vocab_size: int = 1200,
          specials: list[str] = LLAMA3_SPECIALS) -> str:
    """Train ``family``'s tokenizer and write it under ``path`` → path
    (``specials``: the llama3 family's added tokens, at least 10)."""
    byte_alphabet = pre_tokenizers.ByteLevel.alphabet()
    if family in ("llama3", "qwen2"):
        pattern = LLAMA3_PATTERN if family == "llama3" else QWEN2_PATTERN
        tok = Tokenizer(models.BPE())
        if family == "qwen2":
            tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=family == "llama3",
                                     use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        _train(tok, vocab_size, alphabet=byte_alphabet)
        n = tok.get_vocab_size()
        if family == "llama3":
            tok.add_special_tokens(specials)
            bos = n
            tok.post_processor = processors.Sequence([
                processors.ByteLevel(trim_offsets=False),
                processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                              pair="<|begin_of_text|> $A <|begin_of_text|> $B",
                                              special_tokens=[("<|begin_of_text|>", bos)])])
            spec = json.loads(tok.to_str())
            spec["model"]["ignore_merges"] = True
            return _write(path, spec, {"bos_token_id": bos, "eos_token_id": [n + 1, n + 8, n + 9]})
        tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
        return _write(path, json.loads(tok.to_str()))
    if family == "gpt2":
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
        tok.decoder = decoders.ByteLevel()
        tok.post_processor = processors.ByteLevel(trim_offsets=True)
        _train(tok, vocab_size, alphabet=byte_alphabet)
        tok.add_special_tokens(["<|endoftext|>"])
        spec = json.loads(tok.to_str())
        for t in spec["added_tokens"]:
            t["normalized"] = True
        return _write(path, spec)
    if family == "llama2":
        byte_tokens = [f"<0x{b:02X}>" for b in range(256)]
        tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
        # Words for training only: the published file has no pre-tokenizer.
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never")
        _train(tok, vocab_size, special=["<unk>", "<s>", "</s>"] + byte_tokens)
        spec = json.loads(tok.to_str())
        spec["pre_tokenizer"] = None
        spec["added_tokens"] = [t for t in spec["added_tokens"] if t["content"] not in byte_tokens]
        spec["model"].update(byte_fallback=True, fuse_unk=True, unk_token="<unk>")
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
        spec["post_processor"] = json.loads(processors.TemplateProcessing(
            single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)]).__getstate__())
        return _write(path, spec, {"bos_token_id": 1, "eos_token_id": 2})
    raise ValueError(family)


def token_json(path: str) -> dict:
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        return json.load(f)
