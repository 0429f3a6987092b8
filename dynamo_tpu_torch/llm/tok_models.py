"""The models of ``tokenizer.json`` as the ``tokenizers`` library (0.22)
defines them: ``BPE``, ``Unigram``, ``WordPiece`` and ``WordLevel``. Each
maps one pre-tokenized word to ids."""

from __future__ import annotations

import heapq
import random

from dynamo_tpu_torch.llm.tok_common import unsupported

_CACHE_CAP = 10_000  # words kept per model cache, as the library's


def byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class BPE:
    """Byte-pair encoding with merge ranks, as ``tokenizers``' BPE: the
    lowest-ranked adjacent pair merges first, the leftmost among equals.
    ``continuing_subword_prefix`` marks every character but a word's first
    and ``end_of_word_suffix`` its last, for the vocabulary lookups. With
    ``dropout`` p in (0, 1], each merge popped is skipped with probability
    p (draws from ``rng``, seed 0 unless given); the cache and
    ``ignore_merges`` are then bypassed, as in the library."""

    def __init__(self, spec: dict, rng: random.Random | None = None):
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        dropout = spec.get("dropout")
        if dropout is not None and not 0.0 <= float(dropout) <= 1.0:
            raise ValueError(f"BPE dropout {dropout} is not within [0, 1]")
        self.dropout = float(dropout) if dropout else None
        self.rng = rng or random.Random(0)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                # The merged token drops as many leading bytes of the right
                # part as continuing_subword_prefix has (the library's rule).
                joined = a + b.encode("utf-8")[len(self.prefix.encode("utf-8")):].decode("utf-8")
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[joined])
            except (KeyError, UnicodeDecodeError) as e:
                raise ValueError(f"BPE merge {a!r} {b!r}: {e.args[0]!r} is not in the vocab") from e
        self._cache: dict[str, list[int]] = {}

    def _unk_id(self) -> int:
        unk_id = self.vocab.get(self.unk_token)
        if unk_id is None:
            raise ValueError(f"BPE unk_token {self.unk_token!r} is not in the vocab")
        return unk_id

    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids (prefix and suffix, byte fallback,
        unknowns)."""
        syms: list[int] = []
        unk: int | None = None
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = ch
            if i > 0 and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(byte_token(b)) for b in s.encode("utf-8")]
                if None not in fb:
                    syms.extend(fb)
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self._unk_id()
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge(self, syms: list[int]) -> list[int]:
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        dropout, rng = self.dropout, self.rng
        c = list(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                if (m := merges.get((c[i], c[i + 1]))) is not None]
        heapq.heapify(heap)
        skipped: list[tuple[int, int, int]] = []
        while heap:
            top = heapq.heappop(heap)
            if dropout is not None and rng.random() < dropout:
                skipped.append(top)
                continue
            for s in skipped:
                heapq.heappush(heap, s)
            skipped.clear()
            _rank, pos, new_id = top
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
        if self.dropout is not None:
            return self._merge(self._symbols(word))
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
                fb = [self.vocab.get(byte_token(b)) for b in piece.encode("utf-8")] \
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


class WordPiece:
    """Greedy longest-match-first: at each position the longest vocabulary
    entry (past the first, with ``continuing_subword_prefix``); a word
    with an unmatchable rest, or longer than ``max_input_chars_per_word``
    characters, is ``unk_token`` whole."""

    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))
        self._cache: dict[str, list[int]] = {}

    def _unk(self) -> list[int]:
        tid = self.vocab.get(self.unk_token)
        if tid is None:
            raise ValueError(f"WordPiece unk_token {self.unk_token!r} is not in the vocab")
        return [tid]

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        out = self._unk() if len(word) > self.max_chars else self._greedy(word)
        if len(self._cache) < _CACHE_CAP:
            self._cache[word] = out
        return out

    def _greedy(self, word: str) -> list[int]:
        ids: list[int] = []
        start, n = 0, len(word)
        vocab = self.vocab
        while start < n:
            end = n
            while end > start:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                tid = vocab.get(sub)
                if tid is not None:
                    ids.append(tid)
                    break
                end -= 1
            else:
                return self._unk()
            start = end
        return ids

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def id_to_token(self) -> dict[int, str]:
        return {i: t for t, i in self.vocab.items()}


class WordLevel:
    """One id per word; ``unk_token`` for a word not in the vocabulary."""

    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token", "<unk>")

    def tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk_token)
            if tid is None:
                raise ValueError(f"WordLevel unk_token {self.unk_token!r} is not in the vocab")
        return [tid]

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def id_to_token(self) -> dict[int, str]:
        return {i: t for t, i in self.vocab.items()}


def model(spec: dict, rng: random.Random | None = None):
    kind = spec.get("type")
    if kind == "BPE":
        return BPE(spec, rng)
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "WordLevel":
        return WordLevel(spec)
    raise unsupported("model", spec)
