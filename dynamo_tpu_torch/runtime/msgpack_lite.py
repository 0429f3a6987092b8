"""MessagePack in pure Python, for the types the runtime's wire carries.

The JAX package frames every control-plane and request-plane message
with the ``msgpack`` C extension; the machines this port targets do not
carry it. ``packb`` here is byte-identical to ``msgpack.packb(obj,
use_bin_type=True)`` and ``unpackb`` returns what ``msgpack.unpackb(data,
raw=False)`` returns, so a port process and a JAX process read each
other's frames.

Types: None, bool, int in [-2**63, 2**64), float (always packed as
float64, as msgpack-python does), str, bytes / bytearray / memoryview
(bin), list / tuple (array) and dict (map); subclasses pack as their base
type (msgpack's default ``strict_types=False``). ``unpackb`` also reads
float32 (0xca). Arrays decode to lists, bin to bytes, and map keys must
be str or bytes (msgpack's ``strict_map_key``). Anything else raises as
msgpack does: TypeError for an unsupported type, OverflowError for an
int out of range, ValueError for malformed or truncated input.

The ``use_bin_type`` / ``raw`` keywords are accepted so that call sites
read exactly as they do against the C extension; only the values the
runtime uses are supported.
"""

from __future__ import annotations

import struct

__all__ = ["pack_parts", "packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")

_NONE, _FALSE, _TRUE = b"\xc0", b"\xc2", b"\xc3"
# One-byte encodings of the small ints (positive and negative fixint).
_FIXINT = {n: bytes([n & 0xFF]) for n in range(-32, 128)}
_MAX_DEPTH = 511  # msgpack's nesting limit


def _pack_int(n: int, out: list) -> None:
    if -32 <= n < 128:
        out.append(_FIXINT[n])
    elif n >= 0:
        if n < 0x100:
            out.append(b"\xcc" + _B.pack(n))
        elif n < 0x10000:
            out.append(b"\xcd" + _H.pack(n))
        elif n < 0x100000000:
            out.append(b"\xce" + _I.pack(n))
        elif n < 0x10000000000000000:
            out.append(b"\xcf" + _Q.pack(n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x80:
        out.append(b"\xd0" + _b.pack(n))
    elif n >= -0x8000:
        out.append(b"\xd1" + _h.pack(n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + _i.pack(n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_str(s: str, out: list) -> None:
    raw = str.encode(s, "utf-8")
    n = len(raw)
    if n < 32:
        out.append(bytes([0xA0 | n]))
    elif n < 0x100:
        out.append(b"\xd9" + _B.pack(n))
    elif n < 0x10000:
        out.append(b"\xda" + _H.pack(n))
    elif n < 0x100000000:
        out.append(b"\xdb" + _I.pack(n))
    else:
        raise ValueError("String is too large")
    out.append(raw)


def _pack_bin(data, out: list) -> None:
    # A memoryview goes into the output as it is: the final join is the
    # one copy of its bytes (KV page frames are 16 MiB views of the pages).
    raw = _bytes_of(data) if type(data) is memoryview else bytes(data)
    n = len(raw)
    if n < 0x100:
        out.append(b"\xc4" + _B.pack(n))
    elif n < 0x10000:
        out.append(b"\xc5" + _H.pack(n))
    elif n < 0x100000000:
        out.append(b"\xc6" + _I.pack(n))
    else:
        raise ValueError("Bytes object is too large")
    out.append(raw)


def _bytes_of(mv: memoryview) -> memoryview:
    """A memoryview as a flat byte view (copied only if not contiguous)."""
    if mv.format == "B" and mv.ndim == 1 and mv.c_contiguous:
        return mv
    return mv.cast("B") if mv.c_contiguous else memoryview(mv.tobytes())


def _header(n: int, fix: int, b16: bytes, b32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 0x10000:
        return b16 + _H.pack(n)
    return b32 + _I.pack(n)


def _pack(o, out: list, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded.")
    t = type(o)
    # Exact types first (the hot path), then subclasses in msgpack's order.
    if o is None:
        out.append(_NONE)
    elif o is True:
        out.append(_TRUE)
    elif o is False:
        out.append(_FALSE)
    elif t is int:
        _pack_int(o, out)
    elif t is str:
        _pack_str(o, out)
    elif t is float:
        out.append(b"\xcb" + _d.pack(o))
    elif t is dict:
        out.append(_header(len(o), 0x80, b"\xde", b"\xdf"))
        for k, v in o.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif t is list or t is tuple:
        out.append(_header(len(o), 0x90, b"\xdc", b"\xdd"))
        for v in o:
            _pack(v, out, depth + 1)
    elif t is bytes or t is bytearray:
        _pack_bin(o, out)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out.append(b"\xcb" + _d.pack(float(o)))
    elif isinstance(o, (bytes, bytearray)):
        _pack_bin(o, out)
    elif isinstance(o, str):
        _pack_str(o, out)
    elif isinstance(o, dict):
        out.append(_header(len(o), 0x80, b"\xde", b"\xdf"))
        for k, v in o.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif isinstance(o, (list, tuple)):
        out.append(_header(len(o), 0x90, b"\xdc", b"\xdd"))
        for v in o:
            _pack(v, out, depth + 1)
    elif isinstance(o, memoryview):
        _pack_bin(o, out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(o, use_bin_type: bool = True) -> bytes:
    """``o`` → MessagePack bytes (msgpack.packb(o, use_bin_type=True))."""
    if not use_bin_type:
        raise ValueError("msgpack_lite packs with use_bin_type=True only")
    return b"".join(pack_parts(o))


def pack_parts(o) -> list:
    """``o`` → the pieces whose concatenation is ``packb(o)``, uncopied (a
    memoryview value is one piece), so that a caller framing them joins
    the bytes once (runtime/framing.py)."""
    out: list = []
    _pack(o, out, 0)
    return out


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        p = self.pos
        end = p + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        self.pos = end
        return self.buf[p:end]

    def unpack(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]


def _str(r: _Reader, n: int) -> str:
    return r.take(n).decode("utf-8")


def _array(r: _Reader, n: int, depth: int) -> list:
    return [_unpack(r, depth + 1) for _ in range(n)]


def _map(r: _Reader, n: int, depth: int) -> dict:
    d = {}
    for _ in range(n):
        k = _unpack(r, depth + 1)
        if type(k) is not str and type(k) is not bytes:
            raise ValueError(f"{type(k).__name__} is not allowed for map key when strict_map_key=True")
        d[k] = _unpack(r, depth + 1)
    return d


def _unpack(r: _Reader, depth: int):
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded.")
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if c < 0x90:
        return _map(r, c & 0x0F, depth)
    if c < 0xA0:
        return _array(r, c & 0x0F, depth)
    if c < 0xC0:
        return _str(r, c & 0x1F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c == 0xC4:
        return r.take(r.unpack(_B))
    if c == 0xC5:
        return r.take(r.unpack(_H))
    if c == 0xC6:
        return r.take(r.unpack(_I))
    if c == 0xCA:
        return r.unpack(_f)
    if c == 0xCB:
        return r.unpack(_d)
    if c == 0xCC:
        return r.unpack(_B)
    if c == 0xCD:
        return r.unpack(_H)
    if c == 0xCE:
        return r.unpack(_I)
    if c == 0xCF:
        return r.unpack(_Q)
    if c == 0xD0:
        return r.unpack(_b)
    if c == 0xD1:
        return r.unpack(_h)
    if c == 0xD2:
        return r.unpack(_i)
    if c == 0xD3:
        return r.unpack(_q)
    if c == 0xD9:
        return _str(r, r.unpack(_B))
    if c == 0xDA:
        return _str(r, r.unpack(_H))
    if c == 0xDB:
        return _str(r, r.unpack(_I))
    if c == 0xDC:
        return _array(r, r.unpack(_H), depth)
    if c == 0xDD:
        return _array(r, r.unpack(_I), depth)
    if c == 0xDE:
        return _map(r, r.unpack(_H), depth)
    if c == 0xDF:
        return _map(r, r.unpack(_I), depth)
    raise ValueError(f"Unpack failed: unsupported type byte 0x{c:02x}")


def unpackb(data, raw: bool = False):
    """MessagePack bytes → object (msgpack.unpackb(data, raw=False))."""
    if raw:
        raise ValueError("msgpack_lite unpacks with raw=False only")
    r = _Reader(bytes(data))
    out = _unpack(r, 0)
    if r.pos != len(r.buf):
        raise ValueError("unpack(b) received extra data.")
    return out
