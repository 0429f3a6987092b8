"""Tokenizer abstraction + incremental detokenization (port of
``dynamo_tpu/llm/tokenizer.py``, byte tokenizer only).

``ByteTokenizer`` is a self-contained UTF-8 byte-level tokenizer (vocab =
256 bytes + specials) that needs no model files. ``DecodeStream`` holds
output while the decoded window ends in an incomplete UTF-8 sequence and
emits once the text stabilizes. HuggingFace and GGUF tokenizers come with
the loader slice.
"""

from __future__ import annotations

from typing import Protocol, Sequence

_REPLACEMENT = "�"


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    @property
    def eos_token_ids(self) -> list[int]: ...

    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """UTF-8 bytes + specials. BOS=256, EOS=257, PAD=258."""

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, add_bos: bool = False):
        self.add_bos = add_bos

    def encode(self, text: str) -> list[int]:
        ids = list(text.encode("utf-8"))
        if self.add_bos:
            ids.insert(0, self.BOS)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> list[int]:
        return [self.EOS]

    @property
    def vocab_size(self) -> int:
        return 259


class TokenizerNotPortedError(NotImplementedError):
    """A checkpoint's own tokenizer (HF ``tokenizer.json`` or a GGUF
    vocabulary) was asked for: the port has no byte-level BPE or
    SentencePiece tokenizer yet (the tokenizers package is absent on the
    card's machine; the tokenizer slice, ROADMAP A). Serve the checkpoint
    with ``--tokenizer byte``."""

    def __init__(self, model_path: str):
        super().__init__(
            f"{model_path}: its tokenizer (HF tokenizer.json / GGUF vocabulary) is not "
            "ported yet — the tokenizer slice adds it; pass --tokenizer byte to serve "
            "this checkpoint with the byte tokenizer"
        )


def tokenizer_spec_for(model_path: str | None, arg: str | None) -> dict:
    """The CLIs' tokenizer choice. Without a checkpoint: ``arg`` or "byte".
    With one, only an explicit "byte" is served: the JAX CLIs default to
    the checkpoint's own tokenizer, which the port cannot load yet, and it
    refuses rather than silently tokenize by bytes."""
    if model_path is not None and arg is None:
        raise TokenizerNotPortedError(model_path)
    return parse_tokenizer_spec(arg or "byte")


def parse_tokenizer_spec(arg: str) -> dict:
    """CLI string → tokenizer spec dict. This port serves "byte" only."""
    if arg == "byte":
        return {"type": "byte"}
    raise SystemExit(f"unsupported tokenizer spec {arg!r} (this port serves 'byte' only)")


def load_tokenizer(spec: dict) -> Tokenizer:
    """Build a tokenizer from a model card's tokenizer spec."""
    kind = spec.get("type", "byte")
    if kind == "byte":
        return ByteTokenizer(add_bos=bool(spec.get("add_bos", False)))
    raise ValueError(f"unsupported tokenizer type: {kind!r} (this port serves 'byte' only)")


class DecodeStream:
    """Incremental detokenizer: feed token ids, get text deltas that never
    split a multi-byte character (prefix-window algorithm)."""

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special = skip_special_tokens
        self.ids: list[int] = []
        self.prefix_offset = 0
        self.read_offset = 0

    def step(self, token_id: int) -> str | None:
        """Returns the newly-stable text, or None if held back."""
        self.ids.append(int(token_id))
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset : self.read_offset], self.skip_special
        )
        new_text = self.tokenizer.decode(self.ids[self.prefix_offset :], self.skip_special)
        if len(new_text) > len(prefix_text) and not new_text.endswith(_REPLACEMENT):
            out = new_text[len(prefix_text) :]
            self.prefix_offset = self.read_offset
            self.read_offset = len(self.ids)
            return out
        return None

    def step_many(self, token_ids) -> str | None:
        """Feed a whole delta in one call; an unstable tail falls back to
        per-token stepping so the concatenated output is the same."""
        if not token_ids:
            return None
        if len(token_ids) == 1:
            return self.step(token_ids[0])
        start = len(self.ids)
        self.ids.extend(int(t) for t in token_ids)
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset : self.read_offset], self.skip_special
        )
        new_text = self.tokenizer.decode(self.ids[self.prefix_offset :], self.skip_special)
        if len(new_text) > len(prefix_text) and not new_text.endswith(_REPLACEMENT):
            out = new_text[len(prefix_text) :]
            self.prefix_offset = self.read_offset
            self.read_offset = len(self.ids)
            return out
        del self.ids[start:]
        parts = [p for p in (self.step(t) for t in token_ids) if p]
        return "".join(parts) if parts else None

    def flush(self) -> str | None:
        """Emit whatever is still held (end of stream)."""
        new_text = self.tokenizer.decode(self.ids[self.prefix_offset :], self.skip_special)
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset : self.read_offset], self.skip_special
        )
        if len(new_text) > len(prefix_text):
            self.prefix_offset = self.read_offset
            self.read_offset = len(self.ids)
            return new_text[len(prefix_text) :]
        return None
