"""A pure-Python reader and pipeline for HuggingFace ``tokenizer.json``.

The card's machine has neither ``tokenizers`` nor ``regex``, so the port
runs a checkpoint's tokenizer here, component by component as the
``tokenizers`` library (0.22) defines them, ids for ids:

- added tokens, split out of the raw text before normalisation (and the
  ``normalized`` ones out of the normalised text), leftmost-longest, with
  ``special``, ``lstrip``, ``rstrip`` and ``single_word``;
- normalizers ``NFC``, ``Prepend``, ``Replace``, ``Sequence``;
- pre-tokenizers ``Split`` (Isolated), ``ByteLevel``, ``Metaspace``,
  ``Sequence`` (Oniguruma patterns through ``unicode_classes.translate``);
- models ``BPE`` (merge ranks, a per-word cache, ``ignore_merges``,
  ``byte_fallback``, ``fuse_unk``) and ``Unigram`` (Viterbi over scores,
  ``unk_id``, ``byte_fallback``);
- post-processors ``TemplateProcessing`` (single sequence), ``ByteLevel``,
  ``Sequence``;
- decoders ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Sequence``.

These are the components of the presets' published tokenizers
(Llama-3.1, Qwen2, the llama-2 SentencePiece-BPE kind, GPT-2) and of the
GGUF vocabularies (engine/gguf.py). Any other component type raises
``NotImplementedError`` naming it: nothing falls back silently.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Any, Callable, Sequence

from dynamo_tpu_torch.llm.unicode_classes import class_ranges, translate

# GPT-2's pre-tokenizer pattern (ByteLevel with use_regex).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

_CACHE_CAP = 10_000  # words kept per BPE cache, as the library's


def _unsupported(kind: str, spec: dict) -> NotImplementedError:
    return NotImplementedError(f"tokenizer.json {kind} type {spec.get('type')!r} is not ported")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte → printable character map of the ByteLevel components."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _pattern(spec: dict) -> re.Pattern:
    """A Split/Replace ``pattern``: {"String": s} or {"Regex": oniguruma}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    return re.compile(translate(spec["Regex"]))


# -- normalizers -----------------------------------------------------------------


def _normalizer(spec: dict | None) -> Callable[[str], str] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _m: content, s)
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s: str) -> str:
            for f in parts:
                s = f(s)
            return s

        return seq
    raise _unsupported("normalizer", spec)


# -- pre-tokenizers ----------------------------------------------------------------
#
# A piece is (text, at_start): at_start marks the piece that begins at the
# original text's offset 0 (Metaspace's prepend_scheme "first" reads it).

Piece = tuple[str, bool]


def _split_isolated(pat: re.Pattern, text: str, at_start: bool) -> list[Piece]:
    """Matches and the gaps between them, each its own piece (empty ones
    dropped)."""
    out: list[Piece] = []
    prev = 0
    for m in pat.finditer(text):
        a, b = m.span()
        if a == b:
            continue
        if prev != a:
            out.append((text[prev:a], at_start and prev == 0))
        out.append((text[a:b], at_start and a == 0))
        prev = b
    if prev != len(text):
        out.append((text[prev:], at_start and prev == 0))
    return out


def _split_merged_with_next(text: str, delim: str, at_start: bool) -> list[Piece]:
    """Split on each ``delim`` character, each delimiter joined to the
    piece after it (a delimiter followed by another stays alone)."""
    parts: list[tuple[int, int, bool]] = []
    prev = 0
    for i, ch in enumerate(text):
        if ch == delim:
            if prev != i:
                parts.append((prev, i, False))
            parts.append((i, i + 1, True))
            prev = i + 1
    if prev != len(text):
        parts.append((prev, len(text), False))
    merged: list[tuple[int, int]] = []
    next_match = False
    for a, b, is_match in reversed(parts):
        if is_match and not next_match and merged:
            merged[-1] = (a, merged[-1][1])
        else:
            merged.append((a, b))
        next_match = is_match
    return [(text[a:b], at_start and a == 0) for a, b in reversed(merged)]


def _pre_tokenizer(spec: dict | None) -> Callable[[list[Piece]], list[Piece]] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Split":
        if spec.get("invert") or spec.get("behavior") != "Isolated":
            raise NotImplementedError(
                f"tokenizer.json Split behavior {spec.get('behavior')!r} "
                f"(invert={spec.get('invert')}) is not ported; Isolated is")
        pat = _pattern(spec["pattern"])
        return lambda pieces: [q for t, s in pieces for q in _split_isolated(pat, t, s)]
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", True))
        regex = re.compile(translate(GPT2_PATTERN)) if spec.get("use_regex", True) else None

        def byte_level(pieces: list[Piece]) -> list[Piece]:
            out: list[Piece] = []
            for t, s in pieces:
                if prefix and not t.startswith(" "):
                    t = " " + t
                for u, us in (_split_isolated(regex, t, s) if regex else [(t, s)]):
                    out.append(("".join(_BYTE_CHAR[b] for b in u.encode("utf-8")), us))
            return out

        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme", "always")
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
        split = bool(spec.get("split", True))

        def metaspace(pieces: list[Piece]) -> list[Piece]:
            out: list[Piece] = []
            for t, s in pieces:
                t = t.replace(" ", rep)
                if not t.startswith(rep) and (scheme == "always" or (scheme == "first" and s)):
                    t = rep + t
                out.extend(_split_merged_with_next(t, rep, s) if split else [(t, s)])
            return out

        return metaspace
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces: list[Piece]) -> list[Piece]:
            for f in parts:
                pieces = f(pieces)
            return pieces

        return seq
    raise _unsupported("pre_tokenizer", spec)


# -- models ------------------------------------------------------------------------


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class BPE:
    """Byte-pair encoding with merge ranks, as ``tokenizers``' BPE: the
    lowest-ranked adjacent pair merges first, the leftmost among equals."""

    def __init__(self, spec: dict):
        for opt in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(opt):
                raise NotImplementedError(f"BPE {opt} is not ported")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"BPE merge {a!r} {b!r}: {e.args[0]!r} is not in the vocab") from e
        self._cache: dict[str, list[int]] = {}

    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids (byte fallback, unknowns)."""
        syms: list[int] = []
        unk: int | None = None
        for s in word:
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(_byte_token(b)) for b in s.encode("utf-8")]
                if None not in fb:
                    syms.extend(fb)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"BPE unk_token {self.unk_token!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge(self, syms: list[int]) -> list[int]:
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        c = list(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                if (m := merges.get((c[i], c[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue  # a stale entry
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = merges.get((c[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(c, alive) if a]

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and (tid := self.vocab.get(word)) is not None:
            return [tid]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        out = self._merge(self._symbols(word))
        if len(self._cache) < _CACHE_CAP:
            self._cache[word] = out
        return out

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def id_to_token(self) -> dict[int, str]:
        return {i: t for t, i in self.vocab.items()}


class Unigram:
    """SentencePiece unigram: the best-scoring segmentation (Viterbi), an
    unknown character scoring the lowest piece score minus 10, adjacent
    unknowns fused, then byte fallback for them."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        pieces = spec["vocab"]
        self.pieces = [p for p, _ in pieces]
        self.scores = [float(s) for _, s in pieces]
        self.vocab = {p: i for i, p in enumerate(self.pieces)}  # the last of equal pieces
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.min_score = min(self.scores) if self.scores else 0.0
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self._cache: dict[str, list[int]] = {}

    def _segment(self, s: str) -> list[str]:
        n = len(s)
        unk_score = self.min_score - self.UNK_PENALTY
        score = [0.0] * (n + 1)
        start: list[int | None] = [None] * (n + 1)
        ident = [0] * (n + 1)
        vocab, scores = self.vocab, self.scores
        for i in range(n):
            base = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = vocab.get(s[i:j])
                if tid is None:
                    continue
                cand = scores[tid] + base
                if start[j] is None or cand > score[j]:
                    score[j], start[j], ident[j] = cand, i, tid
                if j == i + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown character and no unk_id")
                cand = unk_score + base
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ident[i + 1] = cand, i, self.unk_id
        out: list[str] = []
        fused: list[str] = []
        end = n
        while end > 0:
            a = start[end]
            if self.unk_id is not None and ident[end] == self.unk_id:
                fused.append(s[a:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[a:end])
            end = a
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: list[int] = []
        for piece in self._segment(word):
            tid = self.vocab.get(piece)
            if tid is None:
                fb = [self.vocab.get(_byte_token(b)) for b in piece.encode("utf-8")] \
                    if self.byte_fallback else [None]
                if None not in fb:
                    ids.extend(fb)
                    continue
                tid = self.unk_id
            ids.append(tid)
        if len(self._cache) < _CACHE_CAP:
            self._cache[word] = ids
        return ids

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def id_to_token(self) -> dict[int, str]:
        return dict(enumerate(self.pieces))


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE":
        return BPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise _unsupported("model", spec)


# -- post-processors ---------------------------------------------------------------


def _post_processor(spec: dict | None) -> Callable[[list[int]], list[int]] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        return None  # offsets only
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        template: list[Any] = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                template.append(list(specials[item["SpecialToken"]["id"]]["ids"]))
            elif "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise ValueError("TemplateProcessing single template names sequence B")
                template.append(None)
            else:
                raise ValueError(f"TemplateProcessing piece {item!r}")

        def apply(ids: list[int]) -> list[int]:
            out: list[int] = []
            for t in template:
                out.extend(ids if t is None else t)
            return out

        return apply
    if kind == "Sequence":
        parts = [p for p in (_post_processor(q) for q in spec["processors"]) if p is not None]
        if not parts:
            return None

        def seq(ids: list[int]) -> list[int]:
            for f in parts:
                ids = f(ids)
            return ids

        return seq
    raise _unsupported("post_processor", spec)


# -- decoders ------------------------------------------------------------------------


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    pend = bytearray()

    def flush():
        if pend:
            try:
                out.append(pend.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pend))
            pend.clear()

    for t in tokens:
        if (len(t) == 6 and t.startswith("<0x") and t.endswith(">")
                and all(ch in "0123456789abcdefABCDEF" for ch in t[3:5])):
            pend.append(int(t[3:5], 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


def _byte_level_decode(tokens: list[str]) -> list[str]:
    data = bytearray()
    for t in tokens:
        bs = [_CHAR_BYTE.get(ch) for ch in t]
        data += t.encode("utf-8") if None in bs else bytes(bs)
    return [data.decode("utf-8", errors="replace")]


def _strip(content: str, start: int, stop: int) -> Callable[[str], str]:
    def f(t: str) -> str:
        a, b = 0, len(t)
        for i in range(min(start, len(t))):
            if t[i] != content:
                break
            a = i + 1
        for i in range(min(stop, len(t))):
            j = len(t) - i - 1
            if t[j] != content:
                break
            b = j
        return t[a:b]

    return f


def _decoder(spec: dict | None) -> Callable[[list[str]], list[str]] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda toks: [pat.sub(lambda _m: content, t) for t in toks]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        f = _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
        return lambda toks: [f(t) for t in toks]
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]

        def seq(toks: list[str]) -> list[str]:
            for f in parts:
                toks = f(toks)
            return toks

        return seq
    raise _unsupported("decoder", spec)


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
    pre-tokenizer → model → post-processor) and decode (ids → tokens,
    specials skipped on request → decoder)."""

    def __init__(self, spec: dict):
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post_process = _post_processor(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))
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
        if add_special_tokens and self.post_process is not None:
            ids = self.post_process(ids)
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
