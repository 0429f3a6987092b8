"""Control-plane key-value store with leases and prefix watches.

This is the framework's etcd replacement (reference uses etcd for discovery,
leases, and model cards — lib/runtime/src/transports/etcd.rs:44-103,404-418).
Same semantics, zero external infra:

- keys are utf-8 strings, values are bytes;
- ``create`` mode implements create-if-absent (reference ``kv_create``),
  ``create_or_validate`` matches the reference's idempotent variant;
- *leases* carry a TTL; keys attached to a lease vanish when the lease
  expires or is revoked (liveness: a dead worker's instance keys disappear);
- ``watch_prefix`` yields the current snapshot then live Put/Delete events,
  like the reference's ``kv_get_and_watch_prefix`` → ``PrefixWatcher``.

Two implementations share one async interface:

- :class:`MemoryStore` — in-process, for single-process deployments/tests.
- :class:`TcpStoreClient` + :class:`StoreServer` — a msgpack/TCP server
  hosting a MemoryStore for multi-process clusters. Start one with
  ``python -m dynamo_tpu_torch.runtime.store_server``.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import AsyncIterator

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("store")


class EventKind(Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass(frozen=True)
class WatchEvent:
    kind: EventKind
    key: str
    value: bytes | None
    revision: int


@dataclass
class KvEntry:
    key: str
    value: bytes
    lease_id: int | None
    create_revision: int
    mod_revision: int


class PutMode(Enum):
    OVERWRITE = "overwrite"
    CREATE = "create"  # fail if key exists
    CREATE_OR_VALIDATE = "create_or_validate"  # ok if exists with equal value


class StoreError(Exception):
    """Typed wrapper for server-reported store failures that aren't one of
    the structured kinds below (DT005: untyped RuntimeError can't be
    routed or retried by callers)."""


class KeyExistsError(Exception):
    pass


class LeaseNotFoundError(Exception):
    pass


class Watch:
    """Handle over a prefix watch: async-iterate to receive events."""

    def __init__(self, snapshot: list[KvEntry], queue: asyncio.Queue, cancel_cb):
        self.snapshot = snapshot
        self._queue = queue
        self._cancel_cb = cancel_cb
        self._cancelled = False

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        if self._cancelled:
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    async def cancel(self) -> None:
        if not self._cancelled:
            self._cancelled = True
            await self._cancel_cb()
            self._queue.put_nowait(None)


class KeyValueStore:
    """Abstract async KV store interface (control plane)."""

    async def put(
        self,
        key: str,
        value: bytes,
        lease_id: int | None = None,
        mode: PutMode = PutMode.OVERWRITE,
    ) -> int: ...

    async def get(self, key: str) -> KvEntry | None: ...

    async def get_prefix(self, prefix: str) -> list[KvEntry]: ...

    async def delete(self, key: str) -> bool: ...

    async def delete_prefix(self, prefix: str) -> int: ...

    async def grant_lease(self, ttl: float) -> int: ...

    async def keep_alive(self, lease_id: int) -> None: ...

    async def revoke_lease(self, lease_id: int) -> None: ...

    async def watch_prefix(self, prefix: str) -> Watch: ...

    async def close(self) -> None: ...


@dataclass
class _Lease:
    id: int
    ttl: float
    expires_at: float
    keys: set[str] = field(default_factory=set)


class MemoryStore(KeyValueStore):
    """In-process store; the authoritative implementation the TCP server hosts."""

    def __init__(self, *, clock=time.monotonic):
        self._data: dict[str, KvEntry] = {}
        self._leases: dict[int, _Lease] = {}
        self._revision = 0
        self._lease_ids = itertools.count(1)
        self._watchers: dict[int, tuple[str, asyncio.Queue]] = {}
        self._watch_ids = itertools.count(1)
        self._clock = clock
        self._reaper: asyncio.Task | None = None
        self._closed = False

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            self._reaper = asyncio.get_running_loop().create_task(self._reap_loop())

    async def _reap_loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(0.25)
                await self._expire_leases()
        except asyncio.CancelledError:
            pass

    async def _expire_leases(self) -> None:
        now = self._clock()
        dead = [l for l in self._leases.values() if l.expires_at <= now]
        for lease in dead:
            await self._drop_lease(lease)

    async def _drop_lease(self, lease: _Lease) -> None:
        self._leases.pop(lease.id, None)
        for key in sorted(lease.keys):
            entry = self._data.get(key)
            # Only delete keys still owned by this lease: a later put() may have
            # re-attached the key to a different (live) lease, like etcd.
            if entry is not None and entry.lease_id == lease.id:
                del self._data[key]
                self._notify(EventKind.DELETE, key, None)

    def _notify(
        self, kind: EventKind, key: str, value: bytes | None, revision: int | None = None
    ) -> None:
        if revision is None:
            self._revision += 1
            revision = self._revision
        ev = WatchEvent(kind, key, value, revision)
        for prefix, queue in self._watchers.values():
            if key.startswith(prefix):
                queue.put_nowait(ev)

    async def put(self, key, value, lease_id=None, mode=PutMode.OVERWRITE) -> int:
        self._ensure_reaper()
        existing = self._data.get(key)
        if existing is not None:
            if mode == PutMode.CREATE:
                raise KeyExistsError(key)
            if mode == PutMode.CREATE_OR_VALIDATE:
                if existing.value != value:
                    raise KeyExistsError(f"{key}: exists with different value")
                if existing.lease_id == lease_id:
                    return existing.mod_revision
                # Equal value but new ownership: fall through so the key is
                # re-attached to the caller's lease (etcd semantics) — a
                # restarted worker must not stay tied to its dead lease.
        if lease_id is not None:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            lease.keys.add(key)
        if existing is not None and existing.lease_id not in (None, lease_id):
            # Ownership moved: detach from the previous lease (etcd semantics).
            old = self._leases.get(existing.lease_id)
            if old is not None:
                old.keys.discard(key)
        self._revision += 1
        entry = KvEntry(
            key=key,
            value=value,
            lease_id=lease_id,
            create_revision=existing.create_revision if existing else self._revision,
            mod_revision=self._revision,
        )
        self._data[key] = entry
        self._notify(EventKind.PUT, key, value, revision=entry.mod_revision)
        return entry.mod_revision

    async def get(self, key):
        return self._data.get(key)

    async def get_prefix(self, prefix):
        return [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]

    async def delete(self, key) -> bool:
        entry = self._data.pop(key, None)
        if entry is None:
            return False
        if entry.lease_id is not None and entry.lease_id in self._leases:
            self._leases[entry.lease_id].keys.discard(key)
        self._notify(EventKind.DELETE, key, None)
        return True

    async def delete_prefix(self, prefix) -> int:
        keys = [k for k in list(self._data) if k.startswith(prefix)]
        for k in keys:
            await self.delete(k)
        return len(keys)

    async def grant_lease(self, ttl: float) -> int:
        self._ensure_reaper()
        lease_id = next(self._lease_ids)
        self._leases[lease_id] = _Lease(lease_id, ttl, self._clock() + ttl)
        return lease_id

    async def keep_alive(self, lease_id: int) -> None:
        lease = self._leases.get(lease_id)
        if lease is None:
            raise LeaseNotFoundError(str(lease_id))
        lease.expires_at = self._clock() + lease.ttl

    async def revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.get(lease_id)
        if lease is not None:
            await self._drop_lease(lease)

    async def watch_prefix(self, prefix: str) -> Watch:
        self._ensure_reaper()
        queue: asyncio.Queue = asyncio.Queue()
        watch_id = next(self._watch_ids)
        self._watchers[watch_id] = (prefix, queue)
        snapshot = await self.get_prefix(prefix)

        async def cancel():
            self._watchers.pop(watch_id, None)

        return Watch(snapshot, queue, cancel)

    async def close(self) -> None:
        self._closed = True
        if self._reaper is not None:
            self._reaper.cancel()
        for _, queue in self._watchers.values():
            queue.put_nowait(None)
        self._watchers.clear()


# --- URL-based store resolution -------------------------------------------

_memory_stores: dict[str, MemoryStore] = {}


async def connect_store(url: str, lease_ttl: float = 10.0) -> KeyValueStore:
    """Resolve a store URL to a client.

    ``memory://[name]`` — process-local shared store (one instance per name).
    ``tcp://host:port`` — TCP client to a :class:`StoreServer`.
    """
    if url.startswith("memory://"):
        name = url[len("memory://") :] or "default"
        store = _memory_stores.get(name)
        if store is None or store._closed:
            store = MemoryStore()
            _memory_stores[name] = store
        return store
    if url.startswith("tcp://"):
        from dynamo_tpu_torch.runtime.store_net import TcpStoreClient

        hostport = url[len("tcp://") :]
        host, _, port = hostport.rpartition(":")
        client = TcpStoreClient(host or "127.0.0.1", int(port))
        await client.connect()
        return client
    raise ValueError(f"unsupported store url: {url}")


def reset_memory_stores() -> None:
    """Test helper: drop all named in-process stores."""
    _memory_stores.clear()
