"""Tokenizer abstraction + incremental detokenization (port of
``dynamo_tpu/llm/tokenizer.py``).

- ``HFTokenizer``: a checkpoint's ``tokenizer.json``, run by the port's
  pure-Python pipeline (llm/tokenizer_json.py) where the JAX package
  wraps the ``tokenizers`` library, which the card's machine lacks.
- ``RawTokenizer``: an in-memory pipeline (GGUF vocabularies).
- ``ByteTokenizer``: a self-contained UTF-8 byte-level tokenizer (vocab =
  256 bytes + specials) that needs no model files.

``DecodeStream`` holds output while the decoded window ends in an
incomplete UTF-8 sequence and emits once the text stabilizes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Protocol, Sequence

from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson

log = logging.getLogger("dynamo_tpu_torch.tokenizer")

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


class HFTokenizer:
    """A checkpoint's ``tokenizer.json`` (a file, or a directory holding
    one), run by the port's pure-Python pipeline (llm/tokenizer_json.py).
    ``encode`` adds the post-processor's specials, as ``tokenizers``'
    ``encode(text)`` does by default."""

    def __init__(self, path: str):
        tok_file = path
        if os.path.isdir(path):
            tok_file = os.path.join(path, "tokenizer.json")
        self._tok = TokenizerJson.from_file(tok_file)
        self._eos_ids = self._discover_eos(path)

    def _discover_eos(self, path: str) -> list[int]:
        # generation_config.json / config.json carry eos ids for HF model
        # dirs; fall back to common eos token strings.
        base = path if os.path.isdir(path) else os.path.dirname(path)
        for fname in ("generation_config.json", "config.json"):
            p = os.path.join(base, fname)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        cfg = json.load(f)
                    eos = cfg.get("eos_token_id")
                    if isinstance(eos, int):
                        return [eos]
                    if isinstance(eos, list):
                        return [int(e) for e in eos]
                except (OSError, ValueError):
                    pass
        out = []
        for tok in ("</s>", "<|end_of_text|>", "<|eot_id|>", "<|endoftext|>", "<|im_end|>"):
            tid = self._tok.token_to_id(tok)
            if tid is not None:
                out.append(tid)
        return out

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    @property
    def eos_token_ids(self) -> list[int]:
        return list(self._eos_ids)

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size


class RawTokenizer:
    """An in-memory pipeline (e.g. built from GGUF metadata, engine/gguf.py)
    behind the Tokenizer protocol; ``special_ids`` become special added
    tokens (matched in raw text, skipped on decode)."""

    def __init__(self, tok: TokenizerJson, eos_ids: list[int],
                 special_ids: list[int] | None = None):
        self._tok = tok
        self._eos_ids = [int(i) for i in eos_ids]
        names = [tok.id_to_token(int(i)) for i in special_ids or []]
        tok.add_special_tokens([t for t in names if t is not None])

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    @property
    def eos_token_ids(self) -> list[int]:
        return list(self._eos_ids)

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size


def tokenizer_spec_for(model_path: str | None, arg: str | None) -> dict:
    """The CLIs' tokenizer choice. Without a checkpoint: ``arg`` or "byte".
    With one and no ``arg``: the checkpoint's own tokenizer, ``gguf:`` for a
    GGUF file and ``hf:`` otherwise, as the JAX worker chooses. An explicit
    "byte" serves bytes even with a checkpoint (the JAX CLIs cannot say
    so: "byte" is their default, and it means the checkpoint's own)."""
    if model_path is not None and arg is None:
        from dynamo_tpu_torch.engine.hub import is_gguf

        arg = ("gguf:" if is_gguf(model_path) else "hf:") + model_path
    return parse_tokenizer_spec(arg or "byte")


def parse_tokenizer_spec(arg: str) -> dict:
    """CLI string → tokenizer spec dict: "byte" | "hf:<path>" |
    "gguf:<path>" (shared by the worker and run entrypoints)."""
    if arg == "byte":
        return {"type": "byte"}
    if arg.startswith("hf:"):
        return {"type": "hf", "path": arg[3:]}
    if arg.startswith("gguf:"):
        return {"type": "gguf", "path": arg[5:]}
    raise SystemExit(f"unknown tokenizer spec {arg!r}")


def load_tokenizer(spec: dict) -> Tokenizer:
    """Build a tokenizer from a ModelDeploymentCard tokenizer spec:
    {"type": "byte"}, {"type": "hf", "path": ...}, or
    {"type": "gguf", "path": ...}. Loading a checkpoint's tokenizer logs
    its seconds."""
    kind = spec.get("type", "byte")
    if kind == "byte":
        return ByteTokenizer(add_bos=bool(spec.get("add_bos", False)))
    t0 = time.perf_counter()
    if kind == "hf":
        tok = HFTokenizer(spec["path"])
    elif kind == "gguf":
        from dynamo_tpu_torch.engine.gguf import GGUFFile, tokenizer_from_gguf

        tok = tokenizer_from_gguf(GGUFFile(spec["path"]))
    else:
        raise ValueError(f"unknown tokenizer type: {kind!r}")
    log.info("tokenizer %s:%s loaded in %.3fs (%d ids)", kind, spec["path"],
             time.perf_counter() - t0, tok.vocab_size)
    return tok


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
