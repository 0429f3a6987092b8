"""The port's span export (``runtime/trace_export.py``) against the JAX one.

The round trip of tests/test_observability_e2e.py on the port: finished
spans go to ``fleet/<id>/trace/<trace_id>/<lane>/<seq>`` keys under the
exporter's lease, a prefix scan reassembles them, and closing the exporter
revokes the lease so the fragments go with it. Then across the packages,
on one TCP store server: spans exported by one package's exporter are read
by the other's ``load_fleet_trace``, key for key and span for span.
"""

from __future__ import annotations

import asyncio
import socket

import pytest

from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime import trace_export as jexport
from dynamo_tpu.runtime.logging import TraceContext as JTrace
from dynamo_tpu.runtime.store import connect_store as jconnect
from dynamo_tpu_torch.runtime import trace_export as texport
from dynamo_tpu_torch.runtime import tracing as ttracing
from dynamo_tpu_torch.runtime.logging import TraceContext as TTrace
from dynamo_tpu_torch.runtime.store import connect_store as tconnect
from procutil import ManagedProcess

TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
TRACEPARENT = f"00-{TRACE_ID}-b7ad6b7169203331-01"
PKGS = {"jax": (jtracing, jexport, JTrace, jconnect),
        "port": (ttracing, texport, TTrace, tconnect)}


def record_two(tracing, trace_cls) -> None:
    with tracing.start_span("wire.serve", parent=trace_cls.parse(TRACEPARENT)) as outer:
        with tracing.start_span("engine.decode", parent=outer.trace_context()) as inner:
            inner.set_attrs(tokens=8)


def test_exporter_roundtrip_is_bounded_batched_and_lease_scoped():
    rec = ttracing.SpanRecorder(capacity=4096, ledger_capacity=256)
    prev = ttracing.set_recorder(rec)

    async def go():
        store = await tconnect("memory://torch_trace_export")
        exporter = await texport.TraceExporter(store, "f1", recorder=rec, lane="w0",
                                               interval_s=30.0).start()
        record_two(ttracing, TTrace)
        assert await exporter.flush() == 2
        entries = await store.get_prefix(texport.trace_prefix("f1"))
        assert [e.key for e in entries] == [f"fleet/f1/trace/{TRACE_ID}/w0/00000001"]
        spans = await texport.load_fleet_trace(store, "f1", TRACE_ID)
        assert {d["name"] for d in spans} == {"wire.serve", "engine.decode"}
        assert all(d["trace_id"] == TRACE_ID for d in spans)
        assert await texport.load_fleet_trace(store, "f1", "0" * 32) == []
        # A bounded buffer: the oldest spans go first past max_buffer.
        small = await texport.TraceExporter(store, "f2", recorder=rec, lane="w1",
                                            interval_s=30.0, max_buffer=3).start()
        for _ in range(3):
            record_two(ttracing, TTrace)
        assert await small.flush() == 3
        await small.close()
        # close() revokes the lease: the fragments go with the process.
        await exporter.close()
        assert await texport.load_fleet_trace(store, "f1", TRACE_ID) == []
        await store.close()

    try:
        asyncio.run(asyncio.wait_for(go(), 30))
    finally:
        ttracing.set_recorder(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def store_url():
    port = _free_port()
    proc = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                           "127.0.0.1", "--port", str(port)], name="store")
    proc.wait_for(r"store server: tcp://")
    yield f"tcp://127.0.0.1:{port}"
    proc.terminate()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_spans_exported_by_one_package_load_in_the_other(store_url, writer, reader):
    tr_w, ex_w, trace_w, connect_w = PKGS[writer]
    _tr_r, ex_r, _trace_r, connect_r = PKGS[reader]
    rec = tr_w.SpanRecorder(capacity=4096, ledger_capacity=256)
    prev = tr_w.set_recorder(rec)
    fleet = f"x-{writer}"

    async def go():
        ws, rs = await connect_w(store_url), await connect_r(store_url)
        try:
            exporter = await ex_w.TraceExporter(ws, fleet, recorder=rec, lane=f"{writer}-0",
                                                interval_s=30.0).start()
            record_two(tr_w, trace_w)
            assert await exporter.flush() == 2
            keys = [e.key for e in await rs.get_prefix(ex_r.trace_prefix(fleet))]
            assert keys == [f"fleet/{fleet}/trace/{TRACE_ID}/{writer}-0/00000001"]
            got = await ex_r.load_fleet_trace(rs, fleet, TRACE_ID)
            want = await ex_w.load_fleet_trace(ws, fleet, TRACE_ID)
            assert got == want and len(got) == 2
            decode = next(d for d in got if d["name"] == "engine.decode")
            assert decode["attrs"] == {"tokens": 8} and decode["proc"] == rec.spans()[0].proc
            await exporter.close()
            assert await ex_r.load_fleet_trace(rs, fleet, TRACE_ID) == []
        finally:
            await ws.close()
            await rs.close()

    try:
        asyncio.run(asyncio.wait_for(go(), 30))
    finally:
        tr_w.set_recorder(prev)
