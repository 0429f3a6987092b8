"""A pure-Python reader and pipeline for HuggingFace ``tokenizer.json``.

The card's machine has neither ``tokenizers`` nor ``regex``, so the port
runs a checkpoint's tokenizer here, component by component as the
``tokenizers`` library (0.22) defines them, ids for ids. Every component
type of that library is here, one module a stage:

- added tokens, split out of the raw text before normalisation (and the
  ``normalized`` ones out of the normalised text), leftmost-longest, with
  ``special``, ``lstrip``, ``rstrip`` and ``single_word`` (this module);
- normalizers (llm/tok_normalizers.py), pre-tokenizers
  (llm/tok_pretokenizers.py), models (llm/tok_models.py), decoders and
  post-processors (llm/tok_decoders.py);
- the file's ``truncation`` and ``padding``, applied to the one sequence
  ``encode`` makes, as the library's ``encode(text).ids`` applies them
  (this module).

Characters are decided as the library decides them (llm/unicode_classes.py
and its tables). A type or option value the library does not define raises
``ValueError`` naming it: nothing falls back silently.
"""

from __future__ import annotations

import json
import random
import re
from typing import Sequence

# Re-exported for callers of the module from before the stages were split.
from dynamo_tpu_torch.llm.tok_common import BYTE_CHAR as _BYTE_CHAR  # noqa: F401
from dynamo_tpu_torch.llm.tok_common import bytes_to_unicode  # noqa: F401
from dynamo_tpu_torch.llm.tok_decoders import byte_fallback as _byte_fallback  # noqa: F401
from dynamo_tpu_torch.llm.tok_decoders import decoder, post_processor
from dynamo_tpu_torch.llm.tok_models import model
from dynamo_tpu_torch.llm.tok_normalizers import normalizer
from dynamo_tpu_torch.llm.tok_pretokenizers import pre_tokenizer
from dynamo_tpu_torch.llm.unicode_classes import class_ranges


# -- truncation and padding ------------------------------------------------------------


class Truncation:
    """The file's ``truncation``: at most ``max_length`` ids, less the
    post-processor's specials when it adds them, cut on the ``direction``
    side. ``stride`` only shapes the overflowing parts, which ``encode``
    does not return; the library still refuses one that is not below the
    length kept."""

    def __init__(self, spec: dict):
        self.max_length = int(spec["max_length"])
        self.stride = int(spec.get("stride", 0))
        self.direction = spec.get("direction", "Right")
        self.strategy = spec.get("strategy", "LongestFirst")
        if self.direction not in ("Right", "Left"):
            raise ValueError(f"truncation direction {self.direction!r} is unknown")
        if self.strategy not in ("LongestFirst", "OnlyFirst", "OnlySecond"):
            raise ValueError(f"truncation strategy {self.strategy!r} is unknown")

    def __call__(self, ids: list[int], added: int) -> list[int]:
        limit = self.max_length
        if added:
            if limit < added:
                return ids  # the library's unsigned difference wraps: no limit
            limit -= added
        if len(ids) <= limit:
            return ids
        if self.strategy == "OnlySecond":
            raise ValueError("truncation: second sequence not provided")
        if limit > 0 and self.stride >= limit:
            raise ValueError(f"truncation: stride {self.stride} must be below {limit}, the "
                             "length kept")
        return ids[:limit] if self.direction == "Right" else ids[len(ids) - limit:]


class Padding:
    """The file's ``padding``: ``Fixed(n)`` or ``BatchLongest`` (the one
    sequence's own length), rounded up to ``pad_to_multiple_of``, filled
    with ``pad_id`` on the ``direction`` side."""

    def __init__(self, spec: dict):
        strategy = spec.get("strategy", "BatchLongest")
        if strategy == "BatchLongest":
            self.fixed = None
        elif isinstance(strategy, dict) and set(strategy) == {"Fixed"}:
            self.fixed = int(strategy["Fixed"])
        else:
            raise ValueError(f"padding strategy {strategy!r} is unknown")
        self.direction = spec.get("direction", "Right")
        if self.direction not in ("Right", "Left"):
            raise ValueError(f"padding direction {self.direction!r} is unknown")
        self.multiple = int(spec.get("pad_to_multiple_of") or 0)
        self.pad_id = int(spec.get("pad_id", 0))

    def __call__(self, ids: list[int]) -> list[int]:
        n = len(ids) if self.fixed is None else self.fixed
        if self.multiple and n % self.multiple:
            n += self.multiple - n % self.multiple
        if len(ids) >= n:
            return ids
        pad = [self.pad_id] * (n - len(ids))
        return ids + pad if self.direction == "Right" else pad + ids


# -- added tokens --------------------------------------------------------------------


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


class _AddedMatcher:
    """Leftmost-longest matching of a set of added tokens in a string."""

    def __init__(self, tokens: list[tuple[str, dict]]):
        self.by_content = {c: t for c, t in tokens}
        alts = sorted((c for c in self.by_content if c), key=len, reverse=True)
        self.regex = re.compile("|".join(map(re.escape, alts))) if alts else None

    def split(self, text: str) -> list[tuple[str, int | None, int]]:
        """→ [(substring, added id or None, start offset)] covering text."""
        if self.regex is None or not text:
            return [(text, None, 0)]
        out: list[tuple[str, int | None, int]] = []
        offset = 0
        for m in self.regex.finditer(text):
            a, b = m.span()
            tok = self.by_content[m.group()]
            if tok.get("single_word"):
                if (a > 0 and _is_word_char(text[a - 1])) or (
                        b < len(text) and _is_word_char(text[b])):
                    continue
            if tok.get("lstrip"):
                k = a
                while k > 0 and text[k - 1] in _WS:
                    k -= 1
                a = max(k, offset)
            if tok.get("rstrip"):
                while b < len(text) and text[b] in _WS:
                    b += 1
            if offset < a:
                out.append((text[offset:a], None, offset))
            out.append((text[a:b], tok["id"], a))
            offset = b
        if offset != len(text):
            out.append((text[offset:], None, offset))
        return out


_WS = frozenset(chr(c) for a, b in class_ranges("White_Space") for c in range(a, b + 1))


# -- the tokenizer -------------------------------------------------------------------


class TokenizerJson:
    """One ``tokenizer.json``: encode (added tokens → normalizer →
    pre-tokenizer → model → truncation → post-processor → padding) and
    decode (ids → tokens, specials skipped on request → decoder)."""

    def __init__(self, spec: dict, rng: random.Random | None = None):
        self.normalize = normalizer(spec.get("normalizer"))
        self.pre_tokenize = pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = model(spec["model"], rng)  # rng: BPE dropout's draws
        self.post_process = post_processor(spec.get("post_processor"))
        self.decoder = decoder(spec.get("decoder"))
        self.truncation = Truncation(spec["truncation"]) if spec.get("truncation") else None
        self.padding = Padding(spec["padding"]) if spec.get("padding") else None
        self._id_to_token = self.model.id_to_token()
        self.added: list[dict] = []
        for t in spec.get("added_tokens") or []:
            self._add(dict(t))
        self._refresh()

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def _add(self, tok: dict) -> None:
        self.added = [t for t in self.added if t["content"] != tok["content"]] + [tok]

    def _refresh(self) -> None:
        self.added_by_id = {t["id"]: t for t in self.added}
        self.added_by_content = {t["content"]: t for t in self.added}
        self.special = {t["content"] for t in self.added if t.get("special")}
        raw = [(t["content"], t) for t in self.added if not t.get("normalized")]
        norm = [(self.normalize(t["content"]) if self.normalize else t["content"], t)
                for t in self.added if t.get("normalized")]
        self._raw_matcher = _AddedMatcher(raw)
        self._norm_matcher = _AddedMatcher(norm)
        self._vocab_size = len({**{t: i for i, t in self._id_to_token.items()},
                                **{t["content"]: t["id"] for t in self.added}})

    def add_special_tokens(self, contents: Sequence[str]) -> None:
        """Register model tokens as special added tokens (matched in raw
        text, skipped by ``decode(skip_special_tokens=True)``), as
        ``tokenizers``' ``add_special_tokens([AddedToken(t, special=True)])``."""
        for c in contents:
            tid = self.token_to_id(c)
            if tid is None:
                raise ValueError(f"special token {c!r} is not in the vocab")
            self._add({"id": tid, "content": c, "single_word": False, "lstrip": False,
                       "rstrip": False, "normalized": False, "special": True})
        self._refresh()

    # -- encode --------------------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        for piece, tid, start in self._raw_matcher.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            if not piece:
                continue
            norm = self.normalize(piece) if self.normalize else piece
            for sub, ntid, nstart in self._norm_matcher.split(norm):
                if ntid is not None:
                    ids.append(ntid)
                elif sub:
                    self._tokenize_piece(sub, start == 0 and nstart == 0, ids)
        post = self.post_process
        if self.truncation is not None:
            ids = self.truncation(ids, post.added if post and add_special_tokens else 0)
        if post is not None:
            ids = post(ids, add_special_tokens)
        if self.padding is not None:
            ids = self.padding(ids)
        return ids

    def _tokenize_piece(self, text: str, at_start: bool, ids: list[int]) -> None:
        words = self.pre_tokenize([(text, at_start)]) if self.pre_tokenize else [(text, at_start)]
        tokenize = self.model.tokenize
        for w, _ in words:
            ids.extend(tokenize(w))

    # -- decode --------------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens: list[str] = []
        for i in ids:
            t = self.added_by_id.get(int(i))
            tok = t["content"] if t is not None else self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    # -- vocabulary ------------------------------------------------------------------

    def token_to_id(self, token: str) -> int | None:
        t = self.added_by_content.get(token)
        return t["id"] if t is not None else self.model.token_to_id(token)

    def id_to_token(self, tid: int) -> str | None:
        t = self.added_by_id.get(tid)
        return t["content"] if t is not None else self._id_to_token.get(tid)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size
