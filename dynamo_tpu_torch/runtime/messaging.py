"""Request/response plane: bidirectional framed-TCP streaming RPC.

Replaces the reference's NATS request plane + one-shot TCP response plane
(reference: lib/runtime/src/pipeline/network/egress/addressed_router.rs:86-211
and ingress/push_endpoint.rs:46-136) with a single plane:

- each worker process runs one :class:`EndpointServer` (one TCP port)
  hosting many endpoints keyed by *subject* ``{ns}/{component}/{endpoint}``;
- a caller holds pooled connections per (host, port); requests are
  multiplexed by request id; responses stream back on the same connection
  with an explicit final/error frame (the reference's ``complete_final``
  marker — a truncated stream without it is detectably abnormal);
- cancellation is a client→server frame that trips the server-side
  :class:`~dynamo_tpu_torch.runtime.engine.Context`.

Wire frames (msgpack maps):
  client→server: {t:"req", id, subject, payload, headers} | {t:"cancel", id}
  server→client: {t:"data", id, payload} | {t:"final", id} | {t:"err", id, error}

Hot-path notes (the per-delta token stream rides this plane): data frames
are packed against a per-request preserialized envelope prefix (no
per-frame dict build or key re-encode), written synchronously, and drained
only when the transport buffer actually backs up — one ``drain()`` per
flush instead of one per frame. Sockets run with TCP_NODELAY so
single-delta flushes aren't Nagle-delayed.
"""

from __future__ import annotations

import asyncio
import contextlib
import math
import uuid
from typing import Any, AsyncIterator, Awaitable, Callable

from dynamo_tpu_torch.runtime import framing, tracing
from dynamo_tpu_torch.runtime.chaos import ChaosInjector, ChaosKillError
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, DeadlineExceededError
from dynamo_tpu_torch.runtime.logging import (
    TraceContext,
    get_logger,
    reset_current_trace,
    set_current_trace,
)

log = get_logger("messaging")

Handler = Callable[[Any, Context], AsyncIterator[Any]]

# Drain (backpressure) only once this much is buffered on the transport.
# Below it, writes flush eagerly on their own and drain() would be a no-op
# await + lock acquisition per frame.
DRAIN_HIWAT = 64 * 1024

# Queue marker: the request's Context was cancelled (the reader side
# translates it to a clean end-of-stream instead of polling a waiter task
# per frame).
_CANCELLED = object()


class StreamError(Exception):
    """Remote handler raised; message carries the remote error string."""


class TruncatedStreamError(Exception):
    """Connection dropped before the final frame — worker likely died.

    Analogue of the reference's truncated-stream fault signal
    (reference: push_router.rs:168-201)."""


class NoHandlerError(Exception):
    """Subject not served at the target (analogue of NATS NoResponders)."""


class OverloadedError(Exception):
    """Target refused the request at its admission gate (at capacity).

    The instance is alive — routers retry elsewhere with backoff instead of
    circuit-breaking it; the ingress maps exhaustion to 503 + Retry-After."""


class EndpointServer:
    """Per-process ingress: serves all endpoints this process registered."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        advertise_host: str | None = None,
        max_inflight: int = 0,
        chaos: ChaosInjector | None = None,
        metrics=None,
        lane: str | None = None,
    ):
        self.host = host
        self.port = port
        # Trace lane for handler execution: spans recorded while serving
        # a request are stamped with this process/role label (None keeps
        # the process default) — the fleet trace view's lane identity.
        self.lane = lane
        self.advertise_host = advertise_host or ("127.0.0.1" if host in ("0.0.0.0", "") else host)
        # Worker-side admission gate: per-subject in-flight bound (0 = off).
        self.max_inflight = max_inflight
        self.chaos = chaos
        # Optional MetricsRegistry: serving-plane counters every worker
        # process exposes on its system /metrics.
        self.m_deadline = (
            metrics.counter(
                "deadline_expired_total",
                "Requests that ran out of budget, by enforcement point",
            )
            if metrics is not None
            else None
        )
        self._handlers: dict[str, Handler] = {}
        self._server: asyncio.Server | None = None
        self._inflight: dict[str, int] = {}
        self._draining: set[str] = set()
        self._idle: dict[str, asyncio.Event] = {}
        self._subject_ctxs: dict[str, set[Context]] = {}
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(self) -> "EndpointServer":
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("endpoint server listening on %s:%d", self.host, self.port)
        return self

    @property
    def address(self) -> tuple[str, int]:
        return (self.advertise_host, self.port)

    def register(self, subject: str, handler: Handler) -> None:
        self._handlers[subject] = handler
        self._inflight.setdefault(subject, 0)
        self._idle[subject] = asyncio.Event()
        self._idle[subject].set()
        self._draining.discard(subject)

    def unregister(self, subject: str) -> None:
        self._handlers.pop(subject, None)

    def inflight(self, subject: str) -> int:
        return self._inflight.get(subject, 0)

    async def drain(self, subject: str, timeout: float = 30.0) -> None:
        """Stop accepting new requests for subject; wait up to ``timeout``
        for in-flight ones, then cancel stragglers (long-lived
        infrastructure streams — KV event subscriptions — never end on
        their own; endpoints that serve them use timeout 0).

        Graceful-shutdown path (reference: push_endpoint.rs graceful
        shutdown with inflight counter)."""
        self._draining.add(subject)
        if self._inflight.get(subject, 0) > 0:
            if timeout > 0:
                try:
                    await asyncio.wait_for(self._idle[subject].wait(), timeout)
                except asyncio.TimeoutError:
                    log.warning(
                        "drain timeout for %s (%d inflight); cancelling",
                        subject, self._inflight[subject],
                    )
            for ctx in list(self._subject_ctxs.get(subject, ())):
                ctx.cancel()
            # One scheduling round for handlers to observe cancellation.
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._idle[subject].wait(), 1.0)
        self.unregister(subject)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # Python 3.12 wait_closed() waits for ALL connections, and
            # clients keep pooled connections open — close them ourselves.
            for w in list(self._writers):
                with contextlib.suppress(Exception):
                    w.close()
            await self._server.wait_closed()

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        framing.set_nodelay(writer)
        self._writers.add(writer)
        write_lock = asyncio.Lock()
        tasks: dict[str, asyncio.Task] = {}
        contexts: dict[str, Context] = {}

        async def send(obj) -> None:
            # StreamWriter.write is synchronous, so frames from concurrent
            # request tasks can't interleave; the lock only serializes
            # drain() (asyncio allows a single drain waiter per transport).
            writer.write(framing.pack(obj))
            async with write_lock:
                await writer.drain()

        def abort() -> None:
            """Cut the transport without a final/err frame — the client sees
            exactly what a worker crash produces (TruncatedStreamError)."""
            writer.close()

        try:
            while True:
                msg = await framing.read_frame(reader)
                if msg is None:
                    break
                t = msg.get("t")
                if t == "req":
                    rid = msg["id"]
                    ctx = self._make_context(rid, msg.get("headers") or {})
                    contexts[rid] = ctx
                    task = asyncio.get_running_loop().create_task(
                        self._run_request(msg, ctx, send, abort, writer, write_lock)
                    )
                    tasks[rid] = task
                    task.add_done_callback(lambda _t, r=rid: (tasks.pop(r, None), contexts.pop(r, None)))
                elif t == "cancel":
                    ctx = contexts.get(msg["id"])
                    if ctx is not None:
                        ctx.cancel()
        finally:
            self._writers.discard(writer)
            for ctx in contexts.values():
                ctx.cancel()
            for task in list(tasks.values()):
                task.cancel()
            writer.close()

    def _make_context(self, rid: str, headers: dict) -> Context:
        trace = None
        tp = headers.get("traceparent")
        if tp:
            trace = TraceContext.parse(tp, headers.get("tracestate"))
        ctx = Context(
            request_id=headers.get("context_id") or rid,
            trace=trace,
            metadata=dict(headers.get("metadata") or {}),
        )
        # Deadline travels as remaining seconds and is re-anchored on this
        # process's monotonic clock (gRPC-style; immune to clock skew). A
        # malformed value from a foreign client must not take down the
        # whole multiplexed connection — treat it as "no deadline".
        timeout_s = headers.get("timeout_s")
        if timeout_s is not None:
            try:
                timeout_s = float(timeout_s)
            except (TypeError, ValueError):
                log.warning("ignoring malformed timeout_s header: %r", timeout_s)
            else:
                if math.isfinite(timeout_s):
                    ctx.set_timeout(timeout_s)
        return ctx

    async def _run_request(
        self, msg: dict, ctx: Context, send, abort, writer, write_lock
    ) -> None:
        rid, subject = msg["id"], msg["subject"]
        handler = self._handlers.get(subject)
        if handler is None or subject in self._draining:
            await send({"t": "err", "id": rid, "error": f"no handler for {subject}", "kind": "no_handler"})
            return
        if 0 < self.max_inflight <= self._inflight.get(subject, 0):
            # Worker-side admission gate: refuse before any work happens so
            # the router can place the request on a less-loaded instance.
            await send({
                "t": "err", "id": rid, "kind": "overloaded",
                "error": f"{subject} at capacity ({self.max_inflight} in flight)",
            })
            return
        self._inflight[subject] += 1
        self._idle[subject].clear()
        self._subject_ctxs.setdefault(subject, set()).add(ctx)
        # Worker-side wire span: covers handler execution + frame writes.
        # Re-anchoring ctx.trace on the span nests every downstream span
        # (engine phases, further hops) and log line under this hop. No
        # inbound traceparent ⇒ untraced infra call ⇒ no span.
        # Lane narrowing first, so wire.serve and everything the handler
        # records lands in this server's process/role lane.
        lane_token = tracing.set_lane(self.lane) if self.lane else None
        span = tracing.start_span_if(ctx.trace, "wire.serve", subject=subject)
        if span.recording:
            ctx.trace = span.trace_context()
        token = set_current_trace(ctx.trace)
        n_frames = 0
        gen = handler(msg.get("payload"), ctx)
        # Per-request preserialized data-frame envelope: each delta packs
        # only its payload; write is synchronous and drain happens once per
        # backed-up flush, not once per frame.
        data_prefix = framing.map3_prefix("t", "data", "id", rid, "payload")
        transport = writer.transport
        chaos = self.chaos
        try:
            ctx.check_deadline()  # expired in transit/queue: don't start work
            async for item in gen:
                if ctx.cancelled:
                    break
                ctx.check_deadline()
                if chaos is not None:
                    await chaos.inject_latency()
                    if chaos.should_drop_frame():
                        span.end(status="chaos:frame_drop")
                        abort()
                        return
                writer.write(framing.pack_prefixed(data_prefix, item))
                n_frames += 1
                if transport.get_write_buffer_size() > DRAIN_HIWAT:
                    async with write_lock:
                        await writer.drain()
            if self.chaos is not None and self.chaos.should_truncate():
                span.end(status="chaos:truncate")
                abort()
                return
            await send({"t": "final", "id": rid})
        except asyncio.CancelledError:
            span.end(status="cancelled")
            raise
        except (ConnectionResetError, BrokenPipeError):
            span.end(status="error:connection_lost")
        except ChaosKillError:
            # Injected worker death: drop the transport, no error frame —
            # on the wire this is exactly a crashed process.
            span.end(status="chaos:kill")
            abort()
        except DeadlineExceededError as e:
            span.end(status="deadline")
            if self.m_deadline is not None:
                self.m_deadline.inc(scope="worker")
            try:
                await send({"t": "err", "id": rid, "error": str(e), "kind": "deadline"})
            except (ConnectionResetError, BrokenPipeError):
                pass
        except Exception as e:  # noqa: BLE001 — protocol boundary
            span.end(status=f"error:{type(e).__name__}")
            log.exception("handler error for %s", subject)
            try:
                await send({"t": "err", "id": rid, "error": f"{type(e).__name__}: {e}"})
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            # Close an abandoned handler generator (cancel/chaos paths) so
            # its finallys — engine spans, slot releases — run now.
            with contextlib.suppress(Exception):
                await gen.aclose()
            span.set_attr("frames", n_frames)
            span.end(status="cancelled" if ctx.cancelled else None)
            reset_current_trace(token)
            if lane_token is not None:
                tracing.reset_lane(lane_token)
            self._subject_ctxs.get(subject, set()).discard(ctx)
            self._inflight[subject] -= 1
            if self._inflight[subject] == 0:
                self._idle[subject].set()


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.streams: dict[str, asyncio.Queue] = {}
        self.pump: asyncio.Task | None = None
        self.closed = False

    def start_pump(self) -> None:
        self.pump = asyncio.get_running_loop().create_task(self._pump_loop())

    async def _pump_loop(self) -> None:
        while True:
            msg = await framing.read_frame(self.reader)
            if msg is None:
                break
            queue = self.streams.get(msg.get("id"))
            if queue is not None:
                queue.put_nowait(msg)
        self.closed = True
        for queue in self.streams.values():
            queue.put_nowait(None)  # None ⇒ connection lost mid-stream

    async def send(self, obj) -> None:
        async with self.write_lock:
            await framing.write_frame(self.writer, obj)

    def close(self) -> None:
        self.closed = True
        if self.pump is not None:
            self.pump.cancel()
        self.writer.close()


class MessageClient:
    """Caller side: pooled connections, streaming calls with cancellation."""

    def __init__(self, connect_timeout: float = 5.0):
        self._conns: dict[tuple[str, int], _Connection] = {}
        self._conn_locks: dict[tuple[str, int], asyncio.Lock] = {}
        self.connect_timeout = connect_timeout

    async def _get_conn(self, addr: tuple[str, int]) -> _Connection:
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(addr[0], addr[1]), self.connect_timeout
            )
            framing.set_nodelay(writer)
            conn = _Connection(reader, writer)
            conn.start_pump()
            self._conns[addr] = conn
            return conn

    async def call(
        self,
        addr: tuple[str, int],
        subject: str,
        payload: Any,
        context: Context,
    ) -> AsyncIterator[Any]:
        """Issue a streaming request; yields response payloads.

        Raises NoHandlerError / StreamError / TruncatedStreamError /
        OverloadedError / DeadlineExceededError — callers (PushRouter,
        Migration) use these to distinguish dead-worker from application
        failure from out-of-time."""
        context.check_deadline()
        conn = await self._get_conn(addr)
        # Fresh wire id per call: two concurrent calls sharing a context lineage
        # (e.g. disagg prefill+decode fan-out) must not collide in conn.streams
        # or the server-side per-connection maps. context.id travels in headers
        # for tracing/correlation.
        rid = uuid.uuid4().hex
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = queue
        headers: dict[str, Any] = {"metadata": context.metadata, "context_id": context.id}
        remaining = context.time_remaining()
        if remaining is not None:
            headers["timeout_s"] = remaining
        # Client-side wire span: send → final frame. Its span id is what
        # travels in ``traceparent``, so the server's wire.serve span (and
        # everything under it) parents on this hop exactly. Untraced calls
        # (exporter scrapes, infra subscriptions) stay span-free so they
        # never pollute the phase histograms.
        span = tracing.start_span_if(
            context.trace, "wire.call",
            subject=subject, addr=f"{addr[0]}:{addr[1]}",
        )
        wire_trace = span.trace_context() if span.recording else context.trace
        if wire_trace is not None:
            headers["traceparent"] = wire_trace.traceparent()
            if context.trace is not None and context.trace.tracestate:
                headers["tracestate"] = context.trace.tracestate
        try:
            await conn.send({"t": "req", "id": rid, "subject": subject, "payload": payload, "headers": headers})
        except (ConnectionResetError, BrokenPipeError) as e:
            conn.streams.pop(rid, None)
            span.end(status="error:send_failed")
            raise TruncatedStreamError(f"connection to {addr} lost on send") from e

        async def _gen() -> AsyncIterator[Any]:
            # ONE waiter task per call (not per frame): on cancellation it
            # drops a marker into the response queue, so the hot loop below
            # is a bare queue.get() per frame — no asyncio.wait fan-in, no
            # getter task churn per token.
            async def _pump_cancel() -> None:
                await context.wait_cancelled()
                queue.put_nowait(_CANCELLED)

            cancel_waiter = asyncio.get_running_loop().create_task(_pump_cancel())
            has_deadline = context.deadline is not None
            finished = False
            try:
                while True:
                    if not has_deadline:
                        msg = await queue.get()
                    else:
                        # The wait is bounded by the request deadline: a
                        # stalled worker (or injected latency) can't hold the
                        # caller past its budget — the finally-block cancel
                        # frame frees the worker side.
                        try:
                            msg = await asyncio.wait_for(
                                queue.get(), context.time_remaining()
                            )
                        except asyncio.TimeoutError:
                            span.end(status="deadline")
                            raise DeadlineExceededError(
                                f"request {context.id} exceeded its deadline awaiting {addr}"
                            ) from None
                    if msg is _CANCELLED:
                        span.end(status="cancelled")
                        return
                    if msg is None:
                        span.end(status="error:truncated")
                        raise TruncatedStreamError(f"stream from {addr} truncated")
                    t = msg["t"]
                    if t == "data":
                        yield msg["payload"]
                    elif t == "final":
                        finished = True
                        return
                    elif t == "err":
                        finished = True
                        kind = msg.get("kind")
                        span.end(status=f"error:{kind or 'remote'}")
                        if kind == "no_handler":
                            raise NoHandlerError(msg.get("error", subject))
                        if kind == "overloaded":
                            raise OverloadedError(msg.get("error", subject))
                        if kind == "deadline":
                            raise DeadlineExceededError(msg.get("error", subject))
                        raise StreamError(msg.get("error", "remote error"))
            finally:
                span.end()
                cancel_waiter.cancel()
                conn.streams.pop(rid, None)
                # Abandoned before the final frame (explicit cancel OR the
                # consumer dropped the stream early): tell the worker to stop.
                if not finished and not conn.closed:
                    try:
                        await conn.send({"t": "cancel", "id": rid})
                    except (ConnectionResetError, BrokenPipeError):
                        pass

        return _gen()

    async def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
