"""Length-prefixed msgpack framing over asyncio streams.

The wire format for both the control plane (store) and the request plane
(messaging): ``u32_be length || msgpack payload``. Analogue of the
reference's two-part codec (reference: lib/runtime/src/pipeline/network/
codec/two_part.rs) — here a single msgpack map carries header + body, with
raw ``bytes`` payloads passing through msgpack unencoded.
"""

from __future__ import annotations

import asyncio
import socket
import struct

from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

MAX_FRAME = 256 * 1024 * 1024  # 256 MiB hard cap; KV block transfers chunk below this.

_LEN = struct.Struct(">I")


def pack(obj) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    return _LEN.pack(len(body)) + body


def map3_prefix(k1: str, v1, k2: str, v2, k3: str) -> bytes:
    """Msgpack prefix of the 3-entry map ``{k1: v1, k2: v2, k3: <value>}``:
    everything up to (excluding) the third value. Streaming hot loops
    precompute this once per request so each frame packs only the payload —
    byte-identical on the wire to packing the full dict.
    """
    return b"\x83" + b"".join(
        msgpack.packb(x, use_bin_type=True) for x in (k1, v1, k2, v2, k3)
    )


def pack_prefixed(prefix: bytes, payload) -> bytes:
    """One frame whose msgpack body is ``prefix || packb(payload)``, its
    bytes copied once (a 16 MiB KV page frame is a view of the pages)."""
    parts = msgpack.pack_parts(payload)
    n = len(prefix) + sum(len(p) for p in parts)
    return b"".join([_LEN.pack(n), prefix, *parts])


def set_nodelay(writer: asyncio.StreamWriter) -> None:
    """TCP_NODELAY on a stream's socket: streaming deltas are small frames
    and must not sit out a Nagle round-trip (engine/runner.py already does
    this for the multi-host step stream)."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transport (tests with pipes/unix sockets)


async def read_frame(reader: asyncio.StreamReader):
    """Read one frame; returns the decoded object or None on clean EOF."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return msgpack.unpackb(body, raw=False)


async def write_frame(writer: asyncio.StreamWriter, obj) -> None:
    writer.write(pack(obj))
    await writer.drain()
