"""AsyncEngine: the universal streaming-inference interface, plus request Context.

Reference analogue: ``AsyncEngine<SingleIn<T>, ManyOut<U>, E>`` with a
``Context`` carrying request id and cancellation across pipeline stages
(reference: lib/runtime/src/pipeline.rs:16-124, engine.rs).

Every stage of a serving pipeline — preprocessor, router, backend, engine,
network hop — implements the same shape: one request in, an async stream of
responses out. Operators compose by wrapping a downstream engine.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, AsyncIterator, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.logging import TraceContext

EngineStream = AsyncIterator[Any]


class DeadlineExceededError(Exception):
    """The request's end-to-end deadline passed before it finished.

    Typed so every layer (router, migration, HTTP ingress) can distinguish
    "out of time" from worker faults: it is never retried or migrated, and
    the frontend maps it to a 504."""


class Context:
    """Per-request context: id, distributed trace, cancellation, deadline,
    annotations.

    Cancellation is cooperative and propagates *forward* through pipeline
    stages (each stage passes the same context downstream) and across the
    network (the messaging layer converts it to a cancel frame).

    The deadline is an absolute ``time.monotonic()`` instant local to this
    process; across the wire it travels as *remaining seconds* and each hop
    re-anchors it on its own clock (gRPC-style), so clock skew between
    hosts never extends or shrinks the budget."""

    def __init__(
        self,
        request_id: str | None = None,
        trace: TraceContext | None = None,
        metadata: dict[str, Any] | None = None,
        deadline: float | None = None,
    ):
        self.id = request_id or uuid.uuid4().hex
        self.trace = trace
        self.metadata: dict[str, Any] = metadata or {}
        self.deadline = deadline
        self._cancelled = asyncio.Event()

    @classmethod
    def with_timeout(cls, timeout: float | None, **kwargs: Any) -> "Context":
        """Context whose deadline is ``timeout`` seconds from now."""
        deadline = None if timeout is None else time.monotonic() + timeout
        return cls(deadline=deadline, **kwargs)

    def set_timeout(self, timeout: float) -> None:
        self.deadline = time.monotonic() + timeout

    def time_remaining(self) -> float | None:
        """Seconds left before the deadline (may be negative), or None."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def check_deadline(self) -> None:
        """Raise :class:`DeadlineExceededError` if the deadline has passed."""
        if self.expired:
            raise DeadlineExceededError(f"request {self.id} exceeded its deadline")

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    async def wait_cancelled(self) -> None:
        await self._cancelled.wait()

    def child(self) -> "Context":
        """Context to forward downstream: same id/cancellation/deadline and
        the same trace context. Span ids are minted by the tracing layer at
        actual span boundaries (wire hops, router attempts); re-minting one
        here would orphan downstream spans from their parents."""
        ctx = Context(
            self.id,
            self.trace,
            dict(self.metadata),
            deadline=self.deadline,
        )
        ctx._cancelled = self._cancelled
        return ctx


@runtime_checkable
class AsyncEngine(Protocol):
    """One request in → stream of responses out."""

    def generate(self, request: Any, context: Context) -> EngineStream: ...


class Operator:
    """Base for pipeline stages wrapping a downstream engine."""

    def __init__(self, inner: AsyncEngine):
        self.inner = inner

    def generate(self, request: Any, context: Context) -> EngineStream:  # pragma: no cover
        raise NotImplementedError


async def collect(stream: EngineStream) -> list[Any]:
    """Drain a stream to a list (test/aggregation helper)."""
    return [item async for item in stream]
