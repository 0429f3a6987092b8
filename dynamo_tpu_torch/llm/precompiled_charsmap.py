"""The ``Precompiled`` normalizer of ``tokenizer.json``: a SentencePiece
``precompiled_charsmap`` applied as the ``tokenizers`` library applies it.

The charsmap (base64 in the file) is a little-endian u32 byte count of a
darts-clone double array, that many bytes of it (u32 units), then a pool of
NUL-terminated UTF-8 replacements; a key's leaf value is its replacement's
byte offset in the pool. The library walks the text by extended grapheme
cluster (UAX #29): a cluster of fewer than 6 UTF-8 bytes whose bytes start
with a key (the shortest key wins) becomes that key's replacement, whole;
otherwise each character is replaced by its own key, or kept.

``clusters`` segments by the Grapheme_Cluster_Break, Extended_Pictographic
and Indic_Conjunct_Break tables of llm/unicode_tables.py, rules GB3–GB13 of
Unicode 16.0.
"""

from __future__ import annotations

import base64
import functools
import struct
import sys

from dynamo_tpu_torch.llm import unicode_tables


@functools.cache
def _props() -> tuple[bytes, list[tuple[str | None, str | None, bool]]]:
    """Each code point's index into a list of (Grapheme_Cluster_Break or
    None for Other, Indic_Conjunct_Break or None, Extended_Pictographic),
    built once (about a fifth of a second)."""
    gcb = bytearray(sys.maxunicode + 1)
    names: list[str | None] = [None]
    for a, b, v in unicode_tables.GRAPHEME_CLUSTER_BREAK:
        if v not in names:
            names.append(v)
        gcb[a:b + 1] = bytes([names.index(v)]) * (b - a + 1)
    incb = bytearray(sys.maxunicode + 1)
    inames: list[str | None] = [None]
    for a, b, v in unicode_tables.INDIC_CONJUNCT_BREAK:
        if v not in inames:
            inames.append(v)
        incb[a:b + 1] = bytes([inames.index(v)]) * (b - a + 1)
    pict = bytearray(sys.maxunicode + 1)
    for a, b in unicode_tables.EXTENDED_PICTOGRAPHIC:
        pict[a:b + 1] = b"\x01" * (b - a + 1)
    combos: dict[tuple[int, int, int], int] = {}
    index = bytearray(sys.maxunicode + 1)
    for c in range(sys.maxunicode + 1):
        key = (gcb[c], incb[c], pict[c])
        if key != (0, 0, 0):
            index[c] = combos.setdefault(key, len(combos) + 1)
    table = [(None, None, False)] + [(names[g], inames[i], bool(p)) for g, i, p in combos]
    return bytes(index), table


_CONTROLS = ("CONTROL", "CR", "LF")


def clusters(text: str) -> list[str]:
    """``text``'s extended grapheme clusters."""
    out: list[str] = []
    start = 0
    prev = None
    ri = 0               # regional indicators just before this character
    emoji = False        # after ExtPict Extend*
    emoji_zwj = False    # after ExtPict Extend* ZWJ
    cons = linked = False  # after InCB Consonant [Extend Linker]* (with a Linker)
    index, table = _props()
    for i, ch in enumerate(text):
        g, incb, pict = table[index[ord(ch)]]
        if i > 0:
            if prev == "CR" and g == "LF":
                join = True
            elif prev in _CONTROLS or g in _CONTROLS:
                join = False
            elif prev == "L" and g in ("L", "V", "LV", "LVT"):
                join = True
            elif prev in ("LV", "V") and g in ("V", "T"):
                join = True
            elif prev in ("LVT", "T") and g == "T":
                join = True
            elif g in ("EXTEND", "ZWJ", "SPACINGMARK") or prev == "PREPEND":
                join = True
            elif cons and linked and incb == "CONSONANT":
                join = True
            elif emoji_zwj and pict:
                join = True
            else:
                join = prev == "REGIONALINDICATOR" == g and ri % 2 == 1
            if not join:
                out.append(text[start:i])
                start = i
        emoji_zwj = emoji and g == "ZWJ"
        emoji = pict or (emoji and g == "EXTEND")
        ri = ri + 1 if g == "REGIONALINDICATOR" else 0
        if incb == "CONSONANT":
            cons, linked = True, False
        elif cons and incb in ("EXTEND", "LINKER"):
            linked = linked or incb == "LINKER"
        else:
            cons = linked = False
        prev = g
    if start < len(text):
        out.append(text[start:])
    return out


class Precompiled:
    """A parsed ``precompiled_charsmap``; calling it normalizes a string."""

    def __init__(self, charsmap: str | bytes):
        if not isinstance(charsmap, (str, bytes)):
            raise ValueError(f"Precompiled: the charsmap is {type(charsmap).__name__}")
        blob = base64.b64decode(charsmap) if isinstance(charsmap, str) else charsmap
        size = int.from_bytes(blob[:4], "little")
        if len(blob) < 4 or size == 0 or size % 4 or 4 + size > len(blob):
            raise ValueError(f"Precompiled: a charsmap of {len(blob)} bytes holds no trie")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]
        self.pool.decode("utf-8")  # the library refuses a pool that is not UTF-8
        self._cache: dict[str, str | None] = {}

    def _lookup(self, key: bytes) -> int | None:
        """The value of the shortest key that ``key`` starts with."""
        units = self.units
        pos = units[0] >> 10 << ((units[0] & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                return None
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= unit >> 10 << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> str | None:
        """The replacement of ``chunk``'s shortest key prefix, or None."""
        hit = self._cache.get(chunk, False)
        if hit is not False:
            return hit
        at = self._lookup(chunk.encode("utf-8"))
        out = None
        if at is not None:
            end = self.pool.find(b"\0", at)
            out = self.pool[at:end if end >= 0 else len(self.pool)].decode("utf-8")
        if len(self._cache) < 100_000:
            self._cache[chunk] = out
        return out

    def __call__(self, text: str) -> str:
        out: list[str] = []
        for g in clusters(text):
            if len(g) == 1:
                norm = self.transform(g)
                out.append(g if norm is None else norm)
                continue
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)
