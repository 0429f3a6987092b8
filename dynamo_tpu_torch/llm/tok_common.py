"""What the stages of the port's ``tokenizer.json`` pipeline share: the
error for a type the port does not know, ``Split``/``Replace`` patterns
matched as Oniguruma matches them, and GPT-2's byte ↔ character map."""

from __future__ import annotations

import re

from dynamo_tpu_torch.llm.unicode_classes import onig_find_iter, translate


def unsupported(kind: str, spec: dict) -> ValueError:
    """A component type (or option value) the ``tokenizers`` library does
    not define either: loading fails with its name."""
    return ValueError(f"tokenizer.json {kind} type {spec.get('type')!r} is unknown")


def pattern(spec: dict) -> re.Pattern:
    """A Split/Replace ``pattern``: {"String": s} or {"Regex": oniguruma}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    return re.compile(translate(spec["Regex"]))


def find_matches(pat: re.Pattern, text: str) -> list[tuple[int, int, bool]]:
    """``text`` cut into (start, end, is_match) spans that cover it, as the
    library's ``Pattern::find_matches`` (an empty text is one empty gap)."""
    if not text:
        return [(0, 0, False)]
    out: list[tuple[int, int, bool]] = []
    prev = 0
    for a, b in onig_find_iter(pat, text):
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = b
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def replace(pat: re.Pattern, content: str, text: str) -> str:
    """Every match of ``pat`` in ``text`` replaced by ``content``."""
    return "".join(content if m else text[a:b] for a, b, m in find_matches(pat, text))


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


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def byte_level(text: str) -> str:
    """``text``'s UTF-8 bytes as GPT-2's printable characters."""
    return "".join(BYTE_CHAR[b] for b in text.encode("utf-8"))
