"""WorkQueue: a distributed FIFO work queue over the KV store.

Reference analogue: ``NatsQueue`` — the JetStream work-queue used as the
disaggregated prefill queue (reference: lib/runtime/src/transports/
nats.rs:345-473, docs/architecture/disagg_serving.md:62). Here it rides
the store's existing verbs, so it needs no extra infrastructure:

- enqueue: ``put(queue/<name>/<seq>, payload, mode=CREATE)`` — the key
  embeds a node-monotonic sequence so ordering is FIFO per producer and
  approximately FIFO globally (timestamp-major).
- dequeue: list the prefix, claim the head by ``delete(key)`` — the
  store executes ops serialized, so exactly one contender's delete
  returns True and that contender owns the item. Empty queue → block on
  the prefix watch until a PUT arrives.

Delivery is at-most-once (a consumer crashing between claim and
completion drops the item) — same stance as the reference's
work-queue retention without explicit acks. Items carry msgpack bytes.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time
from typing import Any

from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

from dynamo_tpu_torch.runtime.store import EventKind, KeyValueStore

_QUEUE_ROOT = "queue"


class WorkQueue:
    def __init__(self, store: KeyValueStore, name: str):
        self.store = store
        self.name = name
        self.prefix = f"{_QUEUE_ROOT}/{name}/"
        self._counter = itertools.count()
        self._node = os.urandom(4).hex()

    def _next_key(self) -> str:
        # timestamp-major for cross-producer FIFO ordering; node id +
        # counter break ties and make CREATE collisions impossible.
        return f"{self.prefix}{time.time_ns():020d}-{self._node}-{next(self._counter):08d}"

    async def enqueue(self, item: Any) -> str:
        """Push one msgpack-able item; → its queue key."""
        key = self._next_key()
        await self.store.put(key, msgpack.packb(item, use_bin_type=True))
        return key

    async def dequeue(self, timeout: float | None = None) -> Any | None:
        """Claim and return the oldest item; block until one arrives.
        → None on timeout."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            entries = await self.store.get_prefix(self.prefix)
            for entry in sorted(entries, key=lambda e: e.key):
                if await self.store.delete(entry.key):  # atomic claim
                    return msgpack.unpackb(entry.value, raw=False)
            # Empty (or lost every claim race): wait for the next PUT.
            watch = await self.store.watch_prefix(self.prefix)
            try:
                # Re-list under the watch to close the snapshot gap.
                if watch.snapshot:
                    continue
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                try:
                    event = await asyncio.wait_for(watch.__anext__(), remaining)
                except (asyncio.TimeoutError, StopAsyncIteration):
                    return None
                if event is None or event.kind != EventKind.PUT:
                    continue
            finally:
                await watch.cancel()

    async def depth(self) -> int:
        return len(await self.store.get_prefix(self.prefix))

    async def clear(self) -> int:
        return await self.store.delete_prefix(self.prefix)
