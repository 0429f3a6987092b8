"""Store-backed KV-router decision cache: cross-process sticky routing.

With one frontend process, stickiness is emergent: the process's own
radix index (or ApproxKvIndexer) remembers where it sent a conversation,
so the follow-up turn scores highest on the same engine. With N processes
behind one port, turn 2 can land on a frontend whose index has never seen
the conversation — the KV events may still be in flight, and in
``use_kv_events=False`` mode they never arrive at all.

This cache closes that gap through the existing store:

- after a placement streams its first token, the routing frontend writes
  ``fleet/<fleet_id>/route/<model>/<deepest block hash>`` → worker id;
- every frontend mirrors the prefix via a store watch, so lookups are a
  local dict probe on the routing hot path (no store round-trip);
- a follow-up turn's block-hash chain *extends* the previous turn's, so
  scanning the new request's hashes deepest-first finds the prior
  decision and its shared-prefix depth — fed to the scheduler as an
  overlap floor, not a hard override (a better live-index match or a
  dead worker still wins).

Entries expire by riding **rotating leases**: writes attach to a lease
with ``ttl = decision_ttl`` that is never kept alive; a fresh lease is
granted each half-TTL, so an entry lives between TTL/2 and TTL and the
store reclaims it (emitting DELETEs that prune every mirror). On drain
the process revokes its active leases outright — a restarting fleet must
not serve yesterday's placements (see docs/frontend-fleet.md).

Bounded memory: the mirror is an LRU capped at ``max_entries`` — under
million-conversation traffic the lease TTL alone is not a memory bound
(every live conversation writes one entry per turn), so inserts beyond
the cap evict the coldest entry locally (the store copy still expires by
lease; eviction is per-mirror, not fleet-wide). A per-worker key index
makes the dead-worker tombstone sweep O(worker's entries) instead of a
full-mirror scan (docs/performance.md "Control-plane scaling").
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from collections import OrderedDict

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import EventKind, KeyValueStore

log = get_logger("fleet.decisions")


def route_prefix(fleet_id: str, scope: str | None = None) -> str:
    base = f"fleet/{fleet_id}/route/"
    return base if scope is None else f"{base}{scope}/"


class RouterDecisionCache:
    """One per frontend process; scoped per model via :meth:`scoped`."""

    # Default mirror cap: sized for ~10^6-conversation fleets at roughly
    # 50 MB of dict+tuple overhead per frontend; raise it in config for
    # memory-rich frontends, lower it for sidecars.
    DEFAULT_MAX_ENTRIES = 1_000_000

    def __init__(
        self,
        store: KeyValueStore,
        fleet_id: str,
        ttl: float = 120.0,
        metrics: dict | None = None,
        clock=time.monotonic,
        max_entries: int = DEFAULT_MAX_ENTRIES,
    ):
        self.store = store
        self.fleet_id = fleet_id
        self.ttl = ttl
        self.max_entries = max(1, max_entries)
        # LRU mirror: reads refresh recency, inserts beyond the cap evict
        # the coldest entry (local memory bound only — the store copy
        # expires via its lease and DELETE-prunes every mirror).
        self._mirror: OrderedDict[tuple[str, int], tuple[int, int]] = OrderedDict()
        # worker id → keys pointing at it (dead-worker sweep index).
        self._by_worker: dict[int, set[tuple[str, int]]] = {}
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._workers_watch = None
        self._workers_task: asyncio.Task | None = None
        self._lease_id: int | None = None
        self._lease_born = 0.0
        self._active_leases: list[int] = []
        self._bg: set[asyncio.Task] = set()
        self._closed = False
        self._clock = clock
        self._m = metrics or {}

    async def start(self) -> "RouterDecisionCache":
        self._watch = await self.store.watch_prefix(route_prefix(self.fleet_id))
        for entry in self._watch.snapshot:
            self._apply(entry.key, entry.value)
        self._watch_task = asyncio.get_running_loop().create_task(self._watch_loop())
        return self

    async def watch_workers(self, namespace: str) -> None:
        """Eagerly drop decisions for retired/dead workers. Worker
        registrations (autoscaler/<ns>/workers/<lease hex>) are DELETEd
        on retire and lease-reaped on death; without this watch the
        decision entries only age out via decision_ttl, so post-scale-down
        placements keep boosting a worker that no longer exists."""
        from dynamo_tpu_torch.planner.actuate import workers_prefix

        self._workers_watch = await self.store.watch_prefix(
            workers_prefix(namespace)
        )
        self._workers_task = asyncio.get_running_loop().create_task(
            self._workers_loop()
        )

    async def _workers_loop(self) -> None:
        try:
            async for ev in self._workers_watch:
                if ev.kind != EventKind.DELETE:
                    continue
                try:
                    worker = int(ev.key.rsplit("/", 1)[-1], 16)
                except ValueError:
                    continue
                self.drop_worker(worker)
        except asyncio.CancelledError:
            pass

    def drop_worker(self, worker: int) -> None:
        """Purge every mirror entry pointing at ``worker`` and delete the
        store keys so peers and late-joining snapshots prune too (the
        deletes race across frontends watching the same registration
        prefix, but delete is idempotent)."""
        dead = list(self._by_worker.pop(worker, ()))
        if not dead:
            return
        for k in dead:
            self._mirror.pop(k, None)
        log.info("dropped %d decision(s) for dead worker %x", len(dead), worker)
        if "entries" in self._m:
            self._m["entries"].set(len(self._mirror))
        if self._closed:
            return
        task = asyncio.get_running_loop().create_task(self._delete_keys(dead))
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    async def _delete_keys(self, keys: list[tuple[str, int]]) -> None:
        for scope, h in keys:
            with contextlib.suppress(Exception):
                await self.store.delete(
                    f"{route_prefix(self.fleet_id, scope)}{h:016x}"
                )

    async def close(self, flush: bool = False) -> None:
        """Stop mirroring; ``flush=True`` (the SIGTERM drain path) revokes
        the active write leases so this process's entries vanish NOW
        instead of lingering up to the TTL."""
        if self._closed:
            return
        self._closed = True
        for t in list(self._bg):
            t.cancel()
        for task in (self._watch_task, self._workers_task):
            if task is not None:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
        for watch in (self._watch, self._workers_watch):
            if watch is not None:
                await watch.cancel()
        if flush:
            for lease_id in self._active_leases:
                with contextlib.suppress(Exception):
                    await self.store.revoke_lease(lease_id)
        self._active_leases.clear()

    # -- mirror ------------------------------------------------------------

    def _parse_key(self, key: str) -> tuple[str, int] | None:
        rest = key[len(route_prefix(self.fleet_id)) :]
        scope, _, h = rest.rpartition("/")
        if not scope:
            return None
        try:
            return scope, int(h, 16)
        except ValueError:
            return None

    def _discard(self, key: tuple[str, int]) -> None:
        old = self._mirror.pop(key, None)
        if old is None:
            return
        held = self._by_worker.get(old[0])
        if held is not None:
            held.discard(key)
            if not held:
                del self._by_worker[old[0]]

    def _insert(self, key: tuple[str, int], worker: int, blocks: int) -> None:
        old = self._mirror.get(key)
        if old is not None and old[0] != worker:
            held = self._by_worker.get(old[0])
            if held is not None:
                held.discard(key)
                if not held:
                    del self._by_worker[old[0]]
        self._mirror[key] = (worker, blocks)
        self._mirror.move_to_end(key)
        self._by_worker.setdefault(worker, set()).add(key)
        evicted = 0
        while len(self._mirror) > self.max_entries:
            k, (w, _) = self._mirror.popitem(last=False)
            held = self._by_worker.get(w)
            if held is not None:
                held.discard(k)
                if not held:
                    del self._by_worker[w]
            evicted += 1
        if evicted and "evictions" in self._m:
            self._m["evictions"].inc(evicted)

    def _apply(self, key: str, value: bytes | None) -> None:
        parsed = self._parse_key(key)
        if parsed is None:
            return
        if value is None:
            self._discard(parsed)
        else:
            try:
                d = json.loads(value)
                self._insert(parsed, int(d["w"]), int(d["b"]))
            except (ValueError, KeyError, TypeError):
                log.warning("bad decision entry at %s", key)
                return
        if "entries" in self._m:
            self._m["entries"].set(len(self._mirror))

    async def _watch_loop(self) -> None:
        try:
            async for ev in self._watch:
                self._apply(ev.key, ev.value if ev.kind == EventKind.PUT else None)
        except asyncio.CancelledError:
            pass

    # -- read/write --------------------------------------------------------

    def lookup(self, scope: str, hashes: list[int]) -> tuple[int, int] | None:
        """→ (worker_id, shared_prefix_blocks) for the deepest cached
        decision along this request's hash chain, or None. Local-only."""
        for i in range(len(hashes) - 1, -1, -1):
            key = (scope, hashes[i])
            hit = self._mirror.get(key)
            if hit is not None:
                self._mirror.move_to_end(key)  # LRU: a hit is recency
                if "hits" in self._m:
                    self._m["hits"].inc(model=scope)
                return hit[0], i + 1
        return None

    def record(self, scope: str, hashes: list[int], worker: int) -> None:
        """Publish a placement (fire-and-forget: the routing hot path
        must not wait on the store)."""
        if not hashes or self._closed:
            return
        key_tuple = (scope, hashes[-1])
        if self._mirror.get(key_tuple, (None,))[0] == worker:
            return  # already published (the common repeated-turn case)
        # Optimistic local insert so back-to-back turns on THIS process
        # hit before the watch echo arrives.
        self._insert(key_tuple, worker, len(hashes))
        task = asyncio.get_running_loop().create_task(
            self._write(scope, hashes[-1], worker, len(hashes))
        )
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    async def _write(self, scope: str, h: int, worker: int, blocks: int) -> None:
        try:
            lease = await self._write_lease()
            await self.store.put(
                f"{route_prefix(self.fleet_id, scope)}{h:016x}",
                json.dumps({"w": worker, "b": blocks}).encode(),
                lease_id=lease,
            )
            if "writes" in self._m:
                self._m["writes"].inc(model=scope)
        except Exception as e:  # noqa: BLE001 — the cache is a routing hint; losing a write only costs stickiness, never a request
            log.warning("decision write failed: %s", e)
            # Drop the optimistic insert: an entry that never reached the
            # store has no DELETE event coming to prune it.
            if self._mirror.get((scope, h), (None,))[0] == worker:
                self._discard((scope, h))

    async def _write_lease(self) -> int:
        now = self._clock()
        if self._lease_id is None or now - self._lease_born > self.ttl / 2:
            self._lease_id = await self.store.grant_lease(self.ttl)
            self._lease_born = now
            self._active_leases.append(self._lease_id)
            # Leases older than one TTL have expired server-side already.
            if len(self._active_leases) > 3:
                self._active_leases = self._active_leases[-3:]
        return self._lease_id

    def scoped(self, scope: str) -> "ScopedDecisions":
        return ScopedDecisions(self, scope)


class ScopedDecisions:
    """Per-model handle the KvPushRouter holds (model slug pre-bound)."""

    def __init__(self, cache: RouterDecisionCache, scope: str):
        self.cache = cache
        self.scope = scope

    def lookup(self, hashes: list[int]) -> tuple[int, int] | None:
        return self.cache.lookup(self.scope, hashes)

    def record(self, hashes: list[int], worker: int) -> None:
        self.cache.record(self.scope, hashes, worker)
