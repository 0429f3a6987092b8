"""Global prefix directory: who holds which KV blocks, how warm.

The decision cache (fleet/decisions.py) remembers *where a
conversation was sent* — one deepest-hash → worker hint per placement.
This module publishes the inverse, ground-truth view: every engine
mirrors its actual block RESIDENCY (block-hash → tier) into the store,
and every frontend watch-mirrors the union, so routing can answer "who
holds this prefix, and how warm" for arbitrary requests — including ones
the fleet has never routed (Mooncake's cluster-wide prefix pool, PAPER.md
layer 1-2, applied at the directory plane instead of the data plane).

Wire shape — one key per worker, replaced wholesale:

    fleet/<scope>/kvdir/<worker_id:x>  →  {"w": id, "h": {"<hash:x>": [tier, seq]}}

- ``scope`` is the runtime NAMESPACE (workers do not know frontend
  fleet_ids; both sides share the namespace).
- ``tier`` is 1 (G1/HBM) … 4 (G4 fleet pool) — warmest tier the block is
  resident in. ``seq`` is the publisher's monotonic stamp (bigger =
  touched more recently) — the age metadata for heat scoring.
- The key rides the publisher's own short-TTL lease, kept alive by the
  flush loop: a dead engine's holdings vanish within the TTL and the
  DELETE prunes every mirror (no tombstone GC, same trick as worker
  registrations).
- Whole-value replacement makes convergence trivial: a mirror's view of
  a worker is always one of that worker's actual published snapshots.

Feeds: the G1 feed is the engine's existing KvCacheEvent stream (the
publisher's ``pool_sink`` composes with the KvEventBroadcaster on
``pool.set_event_sink``); G2-G4 come from ``TierStack.set_event_sink``
(block_manager/tiers.py). Consumers: KvPushRouter transfer-vs-recompute
pricing (kv_router/router.py), the autoscaler's cache-aware victim
choice and drain-on-retire (planner/actuate.py, worker/roles.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import EventKind, KeyValueStore

log = get_logger("fleet.directory")


def kvdir_prefix(scope: str) -> str:
    return f"fleet/{scope}/kvdir/"


def kvdir_key(scope: str, worker_id: int) -> str:
    return f"{kvdir_prefix(scope)}{worker_id:x}"


class DirectoryPublisher:
    """Engine-side half: accumulate residency from the pool/tier event
    sinks (any thread), republish the full compact map when dirty."""

    def __init__(
        self,
        store: KeyValueStore,
        scope: str,
        worker_id: int,
        flush_interval: float = 0.5,
        lease_ttl: float = 10.0,
        max_entries: int = 4096,
    ):
        self.store = store
        self.scope = scope
        self.worker_id = worker_id
        self.flush_interval = flush_interval
        self.lease_ttl = lease_ttl
        self.max_entries = max_entries
        # hash → {tier: seq}; a block may be resident in several tiers at
        # once (G1 + its G2 write-through copy); publish the warmest.
        self._holdings: dict[int, dict[int, int]] = {}
        self._seq = 0
        self._dirty = False
        self._lock = threading.Lock()
        self._lease_id: int | None = None
        self._task: asyncio.Task | None = None
        self._closed = False

    # -- event sinks (called from engine/pool threads) ---------------------

    def pool_sink(self, ev) -> None:
        """G1 feed: a block_manager.pool KvCacheEvent."""
        with self._lock:
            if ev.kind == "stored":
                for b in ev.blocks:
                    self._seq += 1
                    self._holdings.setdefault(b.block_hash, {})[1] = self._seq
            elif ev.kind == "removed":
                for h in ev.block_hashes:
                    self._drop_locked(h, 1)
            elif ev.kind == "cleared":
                for h in list(self._holdings):
                    self._drop_locked(h, 1)
            self._dirty = True

    def tier_sink(self, kind: str, tier: int, hashes: list[int]) -> None:
        """G2-G4 feed: TierStack.set_event_sink callback."""
        with self._lock:
            if kind == "stored":
                for h in hashes:
                    self._seq += 1
                    self._holdings.setdefault(h, {})[tier] = self._seq
            else:
                for h in hashes:
                    self._drop_locked(h, tier)
            self._dirty = True

    def _drop_locked(self, h: int, tier: int) -> None:
        tiers = self._holdings.get(h)
        if tiers is None:
            return
        tiers.pop(tier, None)
        if not tiers:
            self._holdings.pop(h, None)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "DirectoryPublisher":
        self._lease_id = await self.store.grant_lease(self.lease_ttl)
        self._task = asyncio.get_running_loop().create_task(self._flush_loop())
        return self

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
        if self._lease_id is not None:
            # Revoke → the holdings key vanishes NOW; mirrors prune this
            # worker before its blocks could route a doomed transfer.
            with contextlib.suppress(Exception):
                await self.store.revoke_lease(self._lease_id)

    async def _flush_loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.flush_interval)
                await self.store.keep_alive(self._lease_id)
                if self._snapshot_if_dirty():
                    await self.flush()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — residency publishing is best-effort; a missed flush only stales the directory one interval
                log.warning("kvdir flush failed: %s", e)

    def _snapshot_if_dirty(self) -> bool:
        with self._lock:
            dirty, self._dirty = self._dirty, False
            return dirty

    async def flush(self) -> None:
        """Publish the current holdings wholesale (warmest tier per hash,
        newest ``max_entries`` kept — the tail is cold by construction)."""
        with self._lock:
            entries = [
                (h, min(tiers), max(tiers.values()))
                for h, tiers in self._holdings.items()
            ]
        if len(entries) > self.max_entries:
            entries.sort(key=lambda e: -e[2])
            entries = entries[: self.max_entries]
        value = json.dumps(
            {
                "w": self.worker_id,
                "h": {f"{h:x}": [tier, seq] for h, tier, seq in entries},
            }
        ).encode()
        await self.store.put(
            kvdir_key(self.scope, self.worker_id), value, lease_id=self._lease_id
        )


class PrefixDirectory:
    """Frontend/planner-side half: watch-mirror every worker's holdings;
    all queries are local dict probes (no store round-trip on the
    routing hot path — same contract as RouterDecisionCache)."""

    def __init__(self, store: KeyValueStore, scope: str, metrics: dict | None = None,
                 max_worker_entries: int = 8192):
        self.store = store
        self.scope = scope
        # Defensive per-worker bound: publishers cap their snapshots at
        # 4096 newest entries, but the mirror must stay bounded even
        # against an oversized/foreign publisher — keep the newest-seq
        # entries and drop the cold tail.
        self.max_worker_entries = max(1, max_worker_entries)
        # worker_id → {hash: (tier, seq)}
        self._workers: dict[int, dict[int, tuple[int, int]]] = {}
        # Inverted index, maintained incrementally by diffing snapshots
        # in _apply: hash → holder worker ids. Turns best_runs/holders/
        # heat from O(workers × chain) scans into O(chain + holders)
        # walks (docs/performance.md "Control-plane scaling").
        self._inv: dict[int, set[int]] = {}
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._m = metrics or {}

    async def start(self) -> "PrefixDirectory":
        self._watch = await self.store.watch_prefix(kvdir_prefix(self.scope))
        for entry in self._watch.snapshot:
            self._apply(entry.key, entry.value)
        self._watch_task = asyncio.get_running_loop().create_task(self._watch_loop())
        return self

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._watch_task
        if self._watch is not None:
            await self._watch.cancel()

    async def _watch_loop(self) -> None:
        try:
            async for ev in self._watch:
                self._apply(ev.key, ev.value if ev.kind == EventKind.PUT else None)
        except asyncio.CancelledError:
            pass

    def _apply(self, key: str, value: bytes | None) -> None:
        tail = key[len(kvdir_prefix(self.scope)) :]
        try:
            wid = int(tail, 16)
        except ValueError:
            return
        if value is None:
            old = self._workers.pop(wid, None)
            if old:
                self._unindex(wid, old)
        else:
            try:
                d = json.loads(value)
                wid = int(d["w"])
                new = {
                    int(h, 16): (int(ts[0]), int(ts[1]))
                    for h, ts in d["h"].items()
                }
            except (ValueError, KeyError, TypeError, IndexError):
                log.warning("bad kvdir entry at %s", key)
                return
            if len(new) > self.max_worker_entries:
                keep = sorted(new.items(), key=lambda kv: -kv[1][1])
                new = dict(keep[: self.max_worker_entries])
            old = self._workers.get(wid)
            if old:
                for h in old:
                    if h not in new:
                        holders = self._inv.get(h)
                        if holders is not None:
                            holders.discard(wid)
                            if not holders:
                                del self._inv[h]
                for h in new:
                    if h not in old:
                        self._inv.setdefault(h, set()).add(wid)
            else:
                for h in new:
                    self._inv.setdefault(h, set()).add(wid)
            self._workers[wid] = new
        if "entries" in self._m:
            self._m["entries"].set(
                sum(len(hs) for hs in self._workers.values())
            )

    def _unindex(self, wid: int, holdings: dict[int, tuple[int, int]]) -> None:
        for h in holdings:
            holders = self._inv.get(h)
            if holders is not None:
                holders.discard(wid)
                if not holders:
                    del self._inv[h]

    # -- queries -----------------------------------------------------------

    def worker_ids(self) -> list[int]:
        return list(self._workers)

    def holders(self, block_hash: int) -> dict[int, int]:
        """→ {worker_id: warmest tier} for every holder of one block."""
        out: dict[int, int] = {}
        for wid in self._inv.get(block_hash, ()):
            hit = self._workers[wid].get(block_hash)
            if hit is not None:
                out[wid] = hit[0]
        return out

    def run_depth(self, worker_id: int, hashes: list[int]) -> int:
        """Leading-run length of ``hashes`` resident on one worker (any
        tier) — the transferable prefix depth for pricing."""
        holdings = self._workers.get(worker_id)
        if not holdings:
            return 0
        n = 0
        for h in hashes:
            if h not in holdings:
                break
            n += 1
        return n

    def best_runs(self, hashes: list[int]) -> dict[int, int]:
        """→ {worker_id: leading-run depth} for every worker with a
        non-empty run — the router's per-candidate fetchable view.

        Walks the chain once over the inverted index, recording each
        holder's depth at the step it stops matching: O(chain + holders),
        independent of fleet size."""
        out: dict[int, int] = {}
        alive: set[int] | None = None
        depth = 0
        for d, h in enumerate(hashes, start=1):
            holders = self._inv.get(h)
            if not holders:
                break
            current = holders if alive is None else alive & holders
            if not current:
                break
            if alive is not None and len(current) < len(alive):
                for w in alive - current:
                    out[w] = d - 1
            alive = set(current)
            depth = d
        if alive:
            for w in alive:
                out[w] = depth
        return out

    def heat(self, worker_id: int) -> float:
        """Exclusivity-weighted resident-prefix heat: each block counts
        1/(1 + other holders), and warmer tiers count more (tier 1 ×1 …
        tier 4 ×1/4 — a G4 copy is fleet-shared by definition, nearly
        free to lose). The scale-down victim is the MINIMUM — killing it
        destroys the least unique cache (planner/actuate.py)."""
        holdings = self._workers.get(worker_id)
        if not holdings:
            return 0.0
        total = 0.0
        for h, (tier, _seq) in holdings.items():
            others = len(self._inv.get(h, ())) - 1
            total += 1.0 / ((1 + others) * tier)
        return total
