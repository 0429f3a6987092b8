"""Store-backed span export: the fleet trace-stitching transport.

Each process's :class:`~dynamo_tpu_torch.runtime.tracing.SpanRecorder` is a
local ring; a request that crossed four processes leaves four fragments.
The :class:`TraceExporter` ships finished spans into the shared control
store under **lease-scoped** keys::

    fleet/<fleet_id>/trace/<trace_id>/<lane>/<batch_seq>  →  JSON [span dicts]

so ``load_fleet_trace`` (and the supervisor's
``GET /debug/fleet/traces/{trace_id}``) can reassemble one complete tree
by prefix scan. Bounded and batched: spans buffer in a fixed-size deque
(oldest dropped first — tracing must never backpressure serving), flush
on a timer, and every key rides the exporter's lease, so a dead
process's fragments age out with it instead of accumulating forever.

Enabled per process by ``DYNTPU_TRACE_EXPORT=1`` (the worker/frontend
CLIs wire it when both tracing and a fleet id are present); without it
the supervisor still stitches via the satellite pull path
(per-child ``/debug/traces`` scrapes merged by fleet/aggregate.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from collections import deque

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import KeyValueStore

log = get_logger("trace_export")

__all__ = ["TraceExporter", "trace_prefix", "load_fleet_trace"]


def trace_prefix(fleet_id: str, trace_id: str | None = None) -> str:
    base = f"fleet/{fleet_id}/trace/"
    return base if trace_id is None else f"{base}{trace_id}/"


class TraceExporter:
    """Batched, bounded, lease-scoped span export off a SpanRecorder.

    Registered as a recorder *sink* (so it sees spans the moment they
    end, with no polling of the ring) into its own bounded buffer; an
    async flusher drains the buffer into store batches. All store I/O
    happens on the flusher task — the sink itself only appends to a
    deque, keeping the recording hot path allocation-cheap."""

    def __init__(
        self,
        store: KeyValueStore,
        fleet_id: str,
        *,
        recorder: tracing.SpanRecorder | None = None,
        lane: str | None = None,
        interval_s: float = 0.5,
        max_buffer: int = 2048,
        max_batch: int = 256,
        lease_ttl_s: float = 60.0,
    ):
        self.store = store
        self.fleet_id = fleet_id
        self.lane = lane or tracing.default_lane()
        self.interval_s = interval_s
        self.max_batch = max_batch
        self._recorder = recorder
        self._buf: deque[dict] = deque(maxlen=max_buffer)
        self._seq = 0
        self._lease_ttl = lease_ttl_s
        self._lease: int | None = None
        self._sink_key: int | None = None
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._closed = False

    async def start(self) -> "TraceExporter":
        rec = self._recorder if self._recorder is not None else tracing.recorder()
        if rec is None:
            log.info("trace export disabled: tracing is off")
            return self
        self._recorder = rec
        self._lease = await self.store.grant_lease(self._lease_ttl)
        self._sink_key = rec.add_sink(self._on_span)
        self._task = asyncio.ensure_future(self._run())
        log.info(
            "trace export on: fleet=%s lane=%s every %.2fs",
            self.fleet_id, self.lane, self.interval_s,
        )
        return self

    def _on_span(self, span) -> None:
        # Recorder sink — may run on any thread; deque.append is atomic.
        self._buf.append(span.to_dict())

    async def _run(self) -> None:
        try:
            while not self._closed:
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), timeout=self.interval_s
                    )
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
                await self.flush()
                if self._lease is not None:
                    try:
                        await self.store.keep_alive(self._lease)
                    except Exception:  # noqa: BLE001 — lease loss ⇒ re-grant
                        self._lease = await self.store.grant_lease(self._lease_ttl)
        except asyncio.CancelledError:
            pass

    async def flush(self) -> int:
        """Drain the buffer into store batches; → spans written."""
        written = 0
        while self._buf:
            # Partition this drain round by trace id: keys nest under the
            # trace so the read side prefix-scans ONE trace, not all.
            by_trace: dict[str, list[dict]] = {}
            n = 0
            while self._buf and n < self.max_batch:
                d = self._buf.popleft()
                by_trace.setdefault(d.get("trace_id") or "", []).append(d)
                n += 1
            for trace_id, batch in by_trace.items():
                if not trace_id:
                    continue
                self._seq += 1
                key = f"{trace_prefix(self.fleet_id, trace_id)}{self.lane}/{self._seq:08d}"
                try:
                    await self.store.put(
                        key,
                        json.dumps(batch, sort_keys=True).encode(),
                        lease_id=self._lease,
                    )
                    written += len(batch)
                except Exception:  # noqa: BLE001 — export is best-effort
                    log.warning("trace export put failed for %s", key, exc_info=True)
        return written

    async def close(self) -> None:
        self._closed = True
        if self._sink_key is not None and self._recorder is not None:
            self._recorder.remove_sink(self._sink_key)
            self._sink_key = None
        if self._task is not None:
            self._wake.set()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.flush()
        if self._lease is not None:
            with contextlib.suppress(Exception):  # lease may have expired already
                await self.store.revoke_lease(self._lease)
            self._lease = None


async def load_fleet_trace(
    store: KeyValueStore, fleet_id: str, trace_id: str
) -> list[dict]:
    """Read every exported fragment of one trace → span dicts (possibly
    with duplicates across lanes; ``chrome_trace_from_dicts`` dedups)."""
    spans: list[dict] = []
    for entry in await store.get_prefix(trace_prefix(fleet_id, trace_id)):
        try:
            batch = json.loads(entry.value.decode())
        except (ValueError, UnicodeDecodeError):
            log.warning("malformed trace batch at %s", entry.key)
            continue
        if isinstance(batch, list):
            spans.extend(d for d in batch if isinstance(d, dict))
    return spans
