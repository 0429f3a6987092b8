"""Worker-side KV event + load metrics publication.

Reference analogue: lib/llm/src/kv_router/publisher.rs — the reference
pushes KV events to a NATS subject and serves ``load_metrics`` over its
stats plane. Our runtime's request plane is a bidirectional streaming RPC,
so events ride a *server-streaming endpoint* instead of a broker: the
router opens a long-lived ``kv_events`` stream to each worker; the worker
first replays a snapshot of currently-registered blocks, then live events.
Worker death ends the stream, which the router turns into a full drop of
that worker's index state — same convergence story as NATS + etcd leases.

Endpoints served per worker:
- ``kv_events``: subscribe stream (snapshot + live KvCacheEvents)
- ``load_metrics``: one-shot ForwardPassMetrics
  (reference: kv_router/publisher.rs:481-523)
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.block_manager.pool import BlockPool
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvCacheEvent, StoredBlock
from dynamo_tpu_torch.runtime.component import endpoint_subject
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("kv_publisher")

KV_EVENTS_ENDPOINT = "kv_events"
LOAD_METRICS_ENDPOINT = "load_metrics"


async def _next_or_cancelled(q: asyncio.Queue, ctx: Context):
    """Await the next queue item, waking early if the request context is
    cancelled (server drain / subscriber disconnect). None = stop."""
    getter = asyncio.get_running_loop().create_task(q.get())
    canceller = asyncio.get_running_loop().create_task(ctx.wait_cancelled())
    try:
        done, _ = await asyncio.wait({getter, canceller}, return_when=asyncio.FIRST_COMPLETED)
        if getter in done:
            # dyntpu: allow[DT002] reason=getter is in asyncio.wait's done set — result() cannot block, it just unwraps
            return getter.result()
        return None
    finally:
        getter.cancel()
        canceller.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await getter


class KvEventBroadcaster:
    """Fan-out of a worker's KV cache events to any number of subscriber
    streams. ``publish`` is thread-safe (engine emits from its scheduler
    thread)."""

    def __init__(self, pool: BlockPool, max_queue: int = 4096):
        self.pool = pool
        self.max_queue = max_queue
        self._loop: asyncio.AbstractEventLoop | None = None
        self._subscribers: set[asyncio.Queue] = set()

    def bind(self, loop: asyncio.AbstractEventLoop | None = None) -> "KvEventBroadcaster":
        self._loop = loop or asyncio.get_running_loop()
        return self

    # Called from the engine/pool (possibly another thread).
    def publish(self, event: KvCacheEvent) -> None:
        loop = self._loop
        if loop is None:
            return
        loop.call_soon_threadsafe(self._fanout, event)

    def _fanout(self, event: KvCacheEvent) -> None:
        for q in list(self._subscribers):
            if q.qsize() >= self.max_queue:
                # Slow subscriber: drop it; it will resubscribe and resync
                # from a fresh snapshot.
                self._subscribers.discard(q)
                q.put_nowait(None)  # poison → end stream
                log.warning("dropping slow kv_events subscriber")
            else:
                q.put_nowait(event)

    async def handler(self, payload: Any, ctx: Context) -> AsyncIterator[dict]:
        """Endpoint handler: snapshot, then live events until cancel."""
        q: asyncio.Queue = asyncio.Queue()
        self._subscribers.add(q)
        try:
            # Snapshot precedes any live event queued after subscription.
            snap = self.pool.snapshot()
            yield KvCacheEvent.cleared(event_id=0).to_dict()  # reset marker
            if snap:
                yield KvCacheEvent(
                    kind="stored",
                    event_id=0,  # snapshot events carry id 0 (pre-stream)
                    blocks=[StoredBlock(h, p) for h, p in snap],
                ).to_dict()
            while not ctx.cancelled:
                event = await _next_or_cancelled(q, ctx)
                if event is None:
                    return
                yield event.to_dict()
        finally:
            self._subscribers.discard(q)


async def serve_kv_endpoints(
    component,
    broadcaster: KvEventBroadcaster,
    metrics_fn: Callable[[], ForwardPassMetrics],
):
    """Attach kv_events + load_metrics endpoints to a worker component."""
    broadcaster.bind()

    async def metrics_handler(payload: Any, ctx: Context):
        yield metrics_fn().to_dict()

    # kv_events streams never end on their own: cancel them on shutdown.
    h1 = await component.endpoint(KV_EVENTS_ENDPOINT).serve(broadcaster.handler, drain_timeout=0.0)
    h2 = await component.endpoint(LOAD_METRICS_ENDPOINT).serve(metrics_handler)
    return h1, h2


class KvEventSubscription:
    """Router-side: one long-lived subscription to a worker's kv_events
    stream, feeding an index apply-callback. Ends (and reports) on worker
    death."""

    def __init__(
        self,
        messaging,
        instance,
        apply: Callable[[int, KvCacheEvent], bool],
        on_end: Callable[[int], None],
    ):
        self.messaging = messaging
        self.instance = instance
        self.apply = apply
        self.on_end = on_end
        self._task: asyncio.Task | None = None
        self._ctx = Context()

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        wid = self.instance.instance_id
        subject = endpoint_subject(
            self.instance.namespace, self.instance.component, KV_EVENTS_ENDPOINT
        )
        try:
            stream = await self.messaging.call(self.instance.address, subject, None, self._ctx)
            async for item in stream:
                event = KvCacheEvent.from_dict(item)
                if not self.apply(wid, event):
                    log.warning("kv event gap from worker %x; resyncing", wid)
                    return  # on_end triggers resubscribe
        except asyncio.CancelledError:
            return
        except Exception as e:  # noqa: BLE001 — stream death = worker gone/restarting
            log.info("kv_events stream from %x ended: %s", wid, e)
        finally:
            self.on_end(wid)

    async def close(self) -> None:
        self._ctx.cancel()
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
