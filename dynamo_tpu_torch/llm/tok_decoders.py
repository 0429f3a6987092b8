"""The decoders and post-processors of ``tokenizer.json`` as the
``tokenizers`` library (0.22) defines them.

A decoder maps the tokens of some ids to strings, which ``decode`` joins:
``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip``,
``Metaspace``, ``WordPiece``, ``CTC``, ``BPEDecoder`` and ``Sequence``.

A post-processor adds special ids around one encoded sequence:
``TemplateProcessing`` (its ``pair`` template is parsed and checked, then
unused, as encoding one sequence never reads it), ``BertProcessing``,
``RobertaProcessing`` (its offset options change no ids), ``ByteLevel``
(offsets only) and ``Sequence``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

from dynamo_tpu_torch.llm.tok_common import CHAR_BYTE, pattern, replace, unsupported
from dynamo_tpu_torch.llm.tok_pretokenizers import metaspace_scheme

Decoder = Callable[[list[str]], list[str]]

# -- decoders ------------------------------------------------------------------------


def byte_fallback(tokens: list[str]) -> list[str]:
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


def byte_level_decode(tokens: list[str]) -> list[str]:
    data = bytearray()
    for t in tokens:
        bs = [CHAR_BYTE.get(ch) for ch in t]
        data += t.encode("utf-8") if None in bs else bytes(bs)
    return [data.decode("utf-8", errors="replace")]


def _strip(content: str, start: int, stop: int) -> Callable[[str], str]:
    """Up to ``start`` leading and ``stop`` trailing ``content`` characters
    off; the library fails where its two cuts cross or ``stop`` passes the
    token's start."""
    def f(t: str) -> str:
        a, b = 0, len(t)
        for i in range(min(start, len(t))):
            if t[i] != content:
                break
            a = i + 1
        for i in range(stop):
            j = len(t) - i - 1
            if j < 0:
                raise ValueError(f"Strip decoder: stop {stop} passes the token {t!r}")
            if t[j] != content:
                break
            b = j
        if a > b:
            raise ValueError(f"Strip decoder: the cuts of token {t!r} cross")
        return t[a:b]

    return f


_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))


def cleanup(text: str) -> str:
    """The WordPiece decoder's cleanup of spaces before punctuation and
    English contractions."""
    for a, b in _CLEANUP:
        text = text.replace(a, b)
    return text


def _metaspace_decoder(spec: dict) -> Decoder:
    """The replacement character becomes a space, and is dropped from the
    first token unless the prepend scheme is "never"."""
    first = metaspace_scheme(spec) != "never"
    rep = spec["replacement"]
    return lambda toks: [t.replace(rep, "" if i == 0 and first else " ")
                         for i, t in enumerate(toks)]


def _wordpiece_decoder(prefix: str, clean: bool) -> Decoder:
    def run(toks: list[str]) -> list[str]:
        out = []
        for i, t in enumerate(toks):
            if i:
                t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
            out.append(cleanup(t) if clean else t)
        return out

    return run


def _ctc(pad: str, delim: str, clean: bool) -> Decoder:
    """Repeats merged, pad tokens removed, the word delimiter a space."""
    def run(toks: list[str]) -> list[str]:
        out = []
        for t, _ in itertools.groupby(toks):
            t = t.replace(pad, "")
            if clean:
                t = cleanup(t).replace(delim, " ")
            if t:
                out.append(t)
        return out

    return run


def _bpe_decoder(suffix: str) -> Decoder:
    """The end-of-word suffix becomes a space, and nothing on the last
    token."""
    return lambda toks: [t.replace(suffix, "" if i == len(toks) - 1 else " ")
                         for i, t in enumerate(toks)]


def decoder(spec: dict | None) -> Decoder | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        return byte_level_decode
    if kind == "Replace":
        pat, content = pattern(spec["pattern"]), spec["content"]
        return lambda toks: [replace(pat, content, t) for t in toks]
    if kind == "ByteFallback":
        return byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        f = _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
        return lambda toks: [f(t) for t in toks]
    if kind == "Metaspace":
        return _metaspace_decoder(spec)
    if kind == "WordPiece":
        return _wordpiece_decoder(spec.get("prefix", "##"), bool(spec.get("cleanup", True)))
    if kind == "CTC":
        return _ctc(spec.get("pad_token", "<pad>"), spec.get("word_delimiter_token", "|"),
                    bool(spec.get("cleanup", True)))
    if kind == "BPEDecoder":
        return _bpe_decoder(spec.get("suffix", "</w>"))
    if kind == "Sequence":
        parts = [decoder(d) for d in spec["decoders"]]

        def seq(toks: list[str]) -> list[str]:
            for f in parts:
                toks = f(toks)
            return toks

        return seq
    raise unsupported("decoder", spec)


# -- post-processors ---------------------------------------------------------------------


class PostProcessor:
    """Maps a list of encodings (id lists) to another, as the library's
    ``process_encodings``: ``encode`` gives it its one sequence and joins
    what comes out. ``added`` counts the special ids it adds to one
    sequence (truncation leaves room for them)."""

    added = 0

    def process(self, encodings: list[list[int]], special: bool) -> list[list[int]]:
        raise NotImplementedError

    def __call__(self, ids: list[int], special: bool = True) -> list[int]:
        return [i for e in self.process([ids], special) for i in e]


class _Template(PostProcessor):
    """TemplateProcessing: one encoding per piece of the single template
    (the pair template for two encodings); special pieces only with
    ``special``."""

    def __init__(self, single: list, pair: list, specials: dict):
        self.single, self.pair, self.specials = single, pair, specials
        self.added = sum(len(specials[p]) for p in single if p not in ("A", "B"))

    def process(self, encodings, special):
        if len(encodings) > 2:
            raise ValueError("TemplateProcessing of more than two encodings")
        out = []
        for piece in self.single if len(encodings) == 1 else self.pair:
            if piece in ("A", "B"):
                out.append(encodings[piece == "B"])
            elif special:
                out.append(list(self.specials[piece]))
        return out


def _template(spec: dict) -> PostProcessor:
    specials = {name: list(tok["ids"]) for name, tok in (spec.get("special_tokens") or {}).items()}

    def pieces(template: list[Any], which: str, seqs: tuple[str, ...]) -> list[str]:
        out: list[str] = []
        for item in template:
            if "SpecialToken" in item:
                out.append(item["SpecialToken"]["id"])
            elif "Sequence" in item and item["Sequence"]["id"] in seqs:
                out.append(item["Sequence"]["id"])
            else:
                raise ValueError(f"TemplateProcessing {which} template piece {item!r}")
        return out

    single = pieces(spec["single"], "single", ("A",))
    pair = pieces(spec.get("pair") or [], "pair", ("A", "B"))
    for name in single:
        if name != "A" and name not in specials:
            raise ValueError(f"TemplateProcessing special token {name!r} is not in special_tokens")
    return _Template(single, pair, specials)


class _Wrap(PostProcessor):
    """BertProcessing / RobertaProcessing: ``cls`` first, ``sep`` after each
    encoding, all joined into one (their offset options change no ids)."""

    added = 2

    def __init__(self, cls: int, sep: int):
        self.cls, self.sep = cls, sep

    def process(self, encodings, special):
        if not special:
            return encodings
        out = [self.cls]
        for e in encodings:
            out += e + [self.sep]
        return [out]


class _Chain(PostProcessor):
    def __init__(self, parts: list[PostProcessor]):
        self.parts = parts
        self.added = sum(p.added for p in parts)

    def process(self, encodings, special):
        for p in self.parts:
            encodings = p.process(encodings, special)
        return encodings


def post_processor(spec: dict | None) -> PostProcessor | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        return None  # offsets only
    if kind == "TemplateProcessing":
        return _template(spec)
    if kind in ("BertProcessing", "RobertaProcessing"):
        return _Wrap(int(spec["cls"][1]), int(spec["sep"][1]))
    if kind == "Sequence":
        parts = [p for p in (post_processor(q) for q in spec["processors"]) if p is not None]
        return _Chain(parts) if parts else None
    raise unsupported("post_processor", spec)
