"""The port's wire against the JAX package's, byte for byte.

- ``msgpack_lite.packb`` is byte-identical to ``msgpack.packb(...,
  use_bin_type=True)`` and ``unpackb`` returns what ``msgpack.unpackb(...,
  raw=False)`` returns, over hypothesis-made values and the length and
  integer edges of every format; what msgpack refuses, it refuses too.
- Frames written by the port's ``framing`` are read by the JAX package's
  and the reverse, over a socketpair (plain and prefixed frames).
- The port's TCP store client works against the JAX ``StoreServer`` and
  the JAX client against the port's server: put, get, prefix, watch and
  lease expiry.
"""

from __future__ import annotations

import asyncio
import math
import socket

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import framing as jframing
from dynamo_tpu.runtime import store as jstore
from dynamo_tpu.runtime import store_net as jstore_net
from dynamo_tpu_torch.runtime import framing as tframing
from dynamo_tpu_torch.runtime import msgpack_lite
from dynamo_tpu_torch.runtime import store as tstore
from dynamo_tpu_torch.runtime import store_net as tstore_net

INT_EDGES = [0, 1, 2**7 - 1, 2**7, 2**8 - 1, 2**8, 2**15, 2**16 - 1, 2**16, 2**31, 2**32 - 1,
             2**32, 2**63 - 1, 2**63, 2**64 - 1, -1, -2**5, -2**5 - 1, -2**7, -2**7 - 1,
             -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63]
LENGTH_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

scalars = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
values = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=6) | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8), inner, max_size=6)),
    max_leaves=30,
)


def ref_pack(v) -> bytes:
    return msgpack.packb(v, use_bin_type=True)


def ref_unpack(b: bytes):
    return msgpack.unpackb(b, raw=False)


def assert_same(v) -> None:
    b = ref_pack(v)
    assert msgpack_lite.packb(v) == b
    assert msgpack_lite.unpackb(b) == ref_unpack(b)


@settings(max_examples=300, deadline=None)
@given(values)
def test_packb_unpackb_match_msgpack(v):
    assert_same(v)


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_edges(n):
    assert_same(n)
    assert_same([n, -n] if -(2**63) <= -n < 2**64 else [n])


@pytest.mark.parametrize("n", LENGTH_EDGES)
def test_length_edges(n):
    assert_same("x" * n)
    assert_same("é" * (n // 2))  # byte length, not character count, picks the format
    assert_same(b"\x00" * n)
    assert_same(bytearray(b"\x01" * n))
    assert_same(list(range(n % 300)) * (n // 300 + 1) if n else [])
    assert_same([None] * n)
    assert_same({f"k{i}": i for i in range(n)})


def test_types_and_subclasses():
    import enum

    class S(str, enum.Enum):
        A = "alpha"

    class I(enum.IntEnum):
        B = 300

    for v in (1.5, -0.0, math.inf, -math.inf, float(2**80), S.A, I.B, memoryview(b"mv"),
              (1, (2, 3)), {"a": {"b": [b"x", None, True, False]}}):
        b = ref_pack(v)
        assert msgpack_lite.packb(v) == b, v
    nan = msgpack_lite.packb(float("nan"))
    assert nan == ref_pack(float("nan")) and math.isnan(msgpack_lite.unpackb(nan))
    # float32 on the wire (other packers emit it) decodes to a Python float
    f32 = msgpack.packb(1.25, use_single_float=True)
    assert f32[0] == 0xCA and msgpack_lite.unpackb(f32) == 1.25


def test_refusals_match_msgpack():
    import numpy as np

    for bad in (object(), np.int64(1), np.float32(1.0), {1, 2}, 1j):
        with pytest.raises(TypeError):
            ref_pack(bad)
        with pytest.raises(TypeError):
            msgpack_lite.packb(bad)
    for big in (2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            ref_pack(big)
        with pytest.raises(OverflowError):
            msgpack_lite.packb(big)
    for raw in (ref_pack({1: 2}), b"\x92\x01", ref_pack(1) + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            msgpack_lite.unpackb(raw)
        with pytest.raises(Exception):
            ref_unpack(raw)


FRAMES = [
    {"type": "request", "id": "r1", "payload": {"token_ids": list(range(300)), "x": b"\x00" * 70000}},
    {"t": "data", "id": 7, "payload": {"token_ids": [1, 2], "log_probs": [-0.5, -1.25]}},
    [None, True, 2**63, -(2**63), "é" * 40],
]


def test_frames_cross_between_packages():
    async def go():
        for writer_mod, reader_mod in ((tframing, jframing), (jframing, tframing)):
            a, b = socket.socketpair()
            _, w = await asyncio.open_connection(sock=a)
            r, w_other = await asyncio.open_connection(sock=b)
            try:
                for obj in FRAMES:
                    await writer_mod.write_frame(w, obj)
                    got = await reader_mod.read_frame(r)
                    assert got == ref_unpack(ref_pack(obj))
                # the streaming hot path: a precomputed map prefix + payload
                prefix = writer_mod.map3_prefix("t", "data", "id", 9, "payload")
                assert prefix == reader_mod.map3_prefix("t", "data", "id", 9, "payload")
                w.write(writer_mod.pack_prefixed(prefix, {"token_ids": [5]}))
                await w.drain()
                assert await reader_mod.read_frame(r) == {"t": "data", "id": 9,
                                                          "payload": {"token_ids": [5]}}
                assert writer_mod.pack(FRAMES[0]) == reader_mod.pack(FRAMES[0])
            finally:
                w.close()
                w_other.close()

    asyncio.run(go())


async def _exercise_store(client, server_store, ttl_lease=0.4):
    """put / get / prefix / watch / lease expiry through ``client``."""
    rev = await client.put("a/1", b"one")
    assert rev > 0
    await client.put("a/2", b"two")
    await client.put("b/1", b"other")
    got = await client.get("a/1")
    assert got.key == "a/1" and got.value == b"one"
    assert await client.get("missing") is None
    assert sorted(e.key for e in await client.get_prefix("a/")) == ["a/1", "a/2"]

    watch = await client.watch_prefix("a/")
    assert sorted(e.key for e in watch.snapshot) == ["a/1", "a/2"]
    lease = await client.grant_lease(ttl_lease)
    await client.put("a/leased", b"L", lease_id=lease)
    await client.delete("a/2")
    events = []
    async with asyncio.timeout(10):
        while len(events) < 3:  # put a/leased, delete a/2, lease expiry deletes a/leased
            ev = await watch.__anext__()
            events.append((ev.kind.value, ev.key, ev.value))
    assert events == [("put", "a/leased", b"L"), ("delete", "a/2", None),
                      ("delete", "a/leased", None)]
    assert await client.get("a/leased") is None
    await watch.cancel()


@pytest.mark.parametrize("direction", ["port client, jax server", "jax client, port server"])
def test_tcp_store_across_packages(direction):
    async def go():
        if direction.startswith("port client"):
            server = await jstore_net.StoreServer().start()
            client = await tstore.connect_store(server.url)
            assert isinstance(client, tstore_net.TcpStoreClient)
        else:
            server = await tstore_net.StoreServer().start()
            client = await jstore.connect_store(server.url)
            assert isinstance(client, jstore_net.TcpStoreClient)
        try:
            await _exercise_store(client, server)
        finally:
            await client.close()
            await server.close()

    asyncio.run(go())
