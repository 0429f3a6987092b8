"""JSONL record/replay for response streams and KV/router events.

Reference analogue: ``TimestampedResponse`` + ``Recorder`` (reference:
lib/llm/src/perf.rs:16-45, lib/llm/src/recorder.rs:16-40) and the KV
event recorder (reference: lib/llm/src/kv_router/recorder.rs) — the
offline tools the reference uses to debug routing and latency: capture
live streams/events with timestamps, then replay them into analysis or
into a router index without any cluster.

File format: one JSON object per line:
    {"t": <seconds since recorder start>, "kind": "...", ...payload}
kinds: "delta" (response stream item, with "rid"), "kv" (KvCacheEvent,
with "worker"), "hit_rate" (router placement outcome).
"""

from __future__ import annotations

import json
import time
from typing import Any, AsyncIterator, Iterator

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context


class JsonlRecorder:
    """Append-only timestamped JSONL sink (sync writes: records are small
    and the OS page cache absorbs them; call close() to flush)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.monotonic()
        self.lines = 0

    def write(self, kind: str, **payload: Any) -> None:
        if self._f.closed:
            return  # model removed mid-stream: drop, never kill the stream
        rec = {"t": round(time.monotonic() - self._t0, 6), "kind": kind, **payload}
        self._f.write(json.dumps(rec) + "\n")
        self.lines += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- sinks -------------------------------------------------------------

    def kv_event_sink(self, worker_id: int = 0):
        """→ callable(KvCacheEvent) for BlockPool/KvEventBroadcaster."""

        def sink(event) -> None:
            self.write("kv", worker=worker_id, event=event.to_dict())

        return sink

    def hit_rate_sink(self):
        """→ callable(KVHitRateEvent) for KvPushRouter.event_sink."""

        def sink(ev) -> None:
            self.write("hit_rate", **ev.to_dict())

        return sink


class RecordingEngine(AsyncEngine):
    """Wraps any AsyncEngine; records every stream item with per-item
    timestamps (reference: perf.rs TimestampedResponse)."""

    def __init__(self, inner, recorder: JsonlRecorder):
        self.inner = inner
        self.recorder = recorder

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        self.recorder.write("request", rid=context.id,
                            request=request if isinstance(request, dict) else None)
        async for item in self.inner.generate(request, context):
            self.recorder.write("delta", rid=context.id,
                                item=item if isinstance(item, dict) else None)
            yield item


def read_records(path: str, kind: str | None = None) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                yield rec


def replay_kv_events(path: str, apply, worker_id: int | None = None) -> int:
    """Feed recorded KV events into ``apply(worker_id, KvCacheEvent)`` —
    the router-index replay harness (reference: kv_router/recorder.rs).
    → number of events applied."""
    from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent

    n = 0
    for rec in read_records(path, kind="kv"):
        wid = rec.get("worker", 0)
        if worker_id is not None and wid != worker_id:
            continue
        apply(wid, KvCacheEvent.from_dict(rec["event"]))
        n += 1
    return n


def stream_timings(path: str) -> dict[str, list[float]]:
    """Per-request item timestamps → offline TTFT/ITL analysis
    (reference: perf.rs)."""
    out: dict[str, list[float]] = {}
    for rec in read_records(path, kind="delta"):
        out.setdefault(rec["rid"], []).append(rec["t"])
    return out
