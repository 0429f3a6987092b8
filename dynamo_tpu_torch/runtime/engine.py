"""AsyncEngine: the streaming-inference interface, plus request Context
(port of ``dynamo_tpu/runtime/engine.py`` without tracing or deadlines).

Every stage of a serving pipeline — preprocessor, backend, engine —
implements the same shape: one request in, an async stream of responses
out. Operators compose by wrapping a downstream engine.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, AsyncIterator, Protocol, runtime_checkable

EngineStream = AsyncIterator[Any]


class Context:
    """Per-request context: id and cooperative cancellation, shared by
    every stage the request passes through."""

    def __init__(self, request_id: str | None = None):
        self.id = request_id or uuid.uuid4().hex
        self._cancelled = asyncio.Event()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    async def wait_cancelled(self) -> None:
        await self._cancelled.wait()

    def child(self) -> "Context":
        """Context to forward downstream: same id and cancellation."""
        ctx = Context(self.id)
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
