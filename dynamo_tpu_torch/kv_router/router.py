"""KvPushRouter: the KV-cache-aware routing engine.

Reference analogue: ``KvRouter``/``KvPushRouter`` (reference: lib/llm/src/
kv_router.rs:225-369): hash the request's prompt blocks, look up per-worker
prefix overlap in the live index, pick the lowest-cost worker (softmax
temperature), inject ``estimated_prefix_hit_num_blocks``, direct-route, and
track the request in the active-sequence ledger until its stream ends.

Index freshness: one KV-event stream subscription per live worker instance
(publisher.KvEventSubscription), reconciled against discovery; a worker
vanishing (lease expiry or stream death) drops its index state. Engines
that publish no events run in ``use_kv_events=False`` mode with the
TTL-predictive ApproxKvIndexer (reference: kv_router.rs:170-176).
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.kv_router.protocols import KVHitRateEvent
from dynamo_tpu_torch.kv_router.indexer import RadixIndex, ShardedRadixIndex
from dynamo_tpu_torch.kv_router.publisher import KvEventSubscription
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler, KvSchedulerConfig
from dynamo_tpu_torch.kv_router.sequence import ActiveSequences
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.messaging import (
    NoHandlerError,
    OverloadedError,
    TruncatedStreamError,
)
from dynamo_tpu_torch.runtime.push_router import NoInstancesError, PushRouter
from dynamo_tpu_torch.tokens import adapter_hash_seed, compute_block_hashes

log = get_logger("kv_router")


@dataclass
class KvRouterConfig:
    block_size: int = 16
    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    use_kv_events: bool = True
    approx_ttl_s: float = 120.0
    max_attempts: int = 3
    # Index sharding (reference: KvIndexerSharded, indexer.rs:856-985):
    # >0 runs the event-driven index across this many shard threads so
    # event floods never stall the routing loop. 0 = single in-loop index.
    index_shards: int = 0
    # Cross-worker KV reuse (the reference's G4 remote tier,
    # lib/llm/src/block_manager.rs:68-81): when the chosen worker's local
    # overlap trails another worker's by at least this many blocks, the
    # request carries a ``peer_prefix`` hint naming that worker; the
    # chosen worker fetches the prefix pages from the peer's host tier
    # (llm/peer_kv.py) instead of recomputing them. 0 disables.
    peer_fetch_min_blocks: int = 4
    # Migration-aware placement (planner/balancer.py): when a fleet
    # balancer relocates decodes off hot engines, set this to the
    # amortized per-move cost in blocks — the scheduler then caps each
    # candidate's decode-load term at fleet_mean + this, pricing
    # "admit on the warm engine, balancer sheds later" over landing
    # cold. None = off (no balancer, load priced at face value).
    migrate_cost_blocks: float | None = None
    # Cluster-scale candidate pruning (docs/performance.md
    # "Control-plane scaling"): the index returns a ranked top-k holder
    # shortlist and the scheduler scores only shortlist ∪ least-loaded-m
    # ∪ sticky/directory hits — O(k) per placement instead of O(fleet).
    # 0 = full scan, byte-for-byte the pre-shortlist behavior. Fleets no
    # larger than shortlist_k + least_loaded_m always take the full scan.
    shortlist_k: int = 16
    least_loaded_m: int = 4


# How long a cached discovery roster stays fresh without a version bump.
# The version counter covers registration/lease/breaker *events*, but an
# open circuit transitions to half-open silently on read — a purely
# version-keyed cache would starve the probe. 100 ms keeps the O(fleet)
# roster scan off the per-request path while admitting probes within a
# tenth of a second of their cooldown.
_ROSTER_TTL_S = 0.1


# Placement decisions are sub-millisecond dict work; the default
# seconds-scale buckets would flatten the whole distribution into the
# first bucket. 50 µs … 1 s covers pruned hot path through full-scan
# stalls at 1000 engines.
_PLACE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 1.0, float("inf"),
)


def register_router_metrics(registry) -> dict:
    """Placement hot-path series (documented in docs/observability.md,
    cataloged by DT006). Returns the metrics dict KvPushRouter accepts;
    merge with the transfer_choices counter where the fleet economy is
    wired."""
    return {
        "place_seconds": registry.histogram(
            "router_place_seconds",
            "Placement decision latency: hash chain, overlap lookup, cost schedule",
            buckets=_PLACE_BUCKETS,
        ),
        "candidates_considered": registry.counter(
            "router_candidates_considered",
            "Workers cost-scored by placements; divide by router_decisions_total for mean candidate-set size",
        ),
        "shortlist_fallback": registry.counter(
            "router_shortlist_fallback_total",
            "Placements that ran the O(fleet) full scan while shortlist pruning was enabled",
        ),
    }


class KvPushRouter:
    """AsyncEngine shape over a DIRECT PushRouter."""

    def __init__(self, push_router: PushRouter, config: KvRouterConfig | None = None,
                 event_sink=None, decisions=None, directory=None, metrics=None):
        self.config = config or KvRouterConfig()
        # callable(KVHitRateEvent) — routing-quality observability
        # (reference: scheduler.rs KVHitRateEvent → components/metrics).
        self.event_sink = event_sink
        # Fleet sticky-routing cache (fleet/decisions.py ScopedDecisions):
        # placements published by SIBLING frontend processes act as an
        # overlap floor, so a conversation's follow-up turn routes to the
        # engine holding its prefix no matter which process accepts it.
        self.decisions = decisions
        # Global prefix directory (fleet/directory.py PrefixDirectory):
        # ground-truth block residency for transfer-vs-recompute pricing.
        # A worker's OWN directory run floors its overlap (the index only
        # sees G1 events; the directory also knows its G2-G4 holdings),
        # and the deepest run held by anyone ELSE prices as a transfer.
        self.directory = directory
        # Optional {"transfer_choices": counter} — the
        # fleet_kv_transfer_vs_recompute_total{choice} feed.
        self._m = metrics or {}
        self.push = push_router
        self.discovery = push_router.discovery
        self.messaging = push_router.messaging
        self.scheduler = KvScheduler(
            KvSchedulerConfig(
                overlap_score_weight=self.config.overlap_score_weight,
                router_temperature=self.config.router_temperature,
                migrate_cost_blocks=self.config.migrate_cost_blocks,
                shortlist_k=self.config.shortlist_k,
                least_loaded_m=self.config.least_loaded_m,
            )
        )
        self.active = ActiveSequences()
        # Cached discovery roster (shortlist mode only): list + membership
        # set + roster sync into ActiveSequences, refreshed on discovery
        # version change or _ROSTER_TTL_S, whichever comes first.
        self._roster: list[int] = []
        self._roster_set: set[int] = set()
        self._roster_version: int = -1
        self._roster_stamp: float = 0.0
        if not self.config.use_kv_events:
            self.index: RadixIndex | ShardedRadixIndex | ApproxKvIndexer = (
                ApproxKvIndexer(ttl_s=self.config.approx_ttl_s)
            )
        elif self.config.index_shards > 0:
            self.index = ShardedRadixIndex(self.config.index_shards)
        else:
            self.index = RadixIndex()
        self._subs: dict[int, KvEventSubscription] = {}
        self._sub_started: dict[int, float] = {}
        self._sync_task: asyncio.Task | None = None
        self._resync = asyncio.Event()
        self._bg_tasks: set[asyncio.Task] = set()

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> "KvPushRouter":
        if self.config.use_kv_events and self._sync_task is None:
            self._reconcile()
            self._sync_task = asyncio.get_running_loop().create_task(self._sync_loop())
        return self

    async def close(self) -> None:
        if self._sync_task is not None:
            self._sync_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._sync_task
        for sub in list(self._subs.values()):
            await sub.close()
        self._subs.clear()
        if isinstance(self.index, ShardedRadixIndex):
            self.index.close()

    async def _sync_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            v = self.discovery.version  # read BEFORE reconcile: no lost wakeup
            self._resync.clear()
            self._reconcile()
            waiter = loop.create_task(self.discovery.wait_changed(v))
            resync = loop.create_task(self._resync.wait())
            try:
                await asyncio.wait({waiter, resync}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                waiter.cancel()
                resync.cancel()

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _reconcile(self) -> None:
        assert isinstance(self.index, (RadixIndex, ShardedRadixIndex))
        live = {i.instance_id: i for i in self.discovery.available()}
        for wid in list(self._subs):
            if wid not in live:
                sub = self._subs.pop(wid)
                self._spawn(sub.close())
                self.index.remove_worker(wid)
                self.active.remove_worker(wid)
        for wid, inst in live.items():
            if wid not in self._subs:
                sub = KvEventSubscription(
                    self.messaging, inst, self.index.apply, self._on_sub_end
                )
                self._subs[wid] = sub
                self._sub_started[wid] = asyncio.get_running_loop().time()
                sub.start()

    def _on_sub_end(self, wid: int) -> None:
        # Stream died (worker gone or event gap): drop state; if the worker
        # is still discovered, the reconcile pass resubscribes fresh. A
        # subscription that died young (endpoint missing/broken) is retried
        # with a delay so a permanently-failing worker can't hot-loop us.
        self._subs.pop(wid, None)
        if isinstance(self.index, (RadixIndex, ShardedRadixIndex)):
            self.index.remove_worker(wid)
        loop = asyncio.get_running_loop()
        lifetime = loop.time() - self._sub_started.pop(wid, 0.0)
        if lifetime < 1.0:
            loop.call_later(1.0, self._resync.set)
        else:
            self._resync.set()

    # -- routing ----------------------------------------------------------

    def _place(self, token_ids: list[int], excluded: set[int] = frozenset(),
               adapter_id: str | None = None):
        """Shared placement recipe: hash → overlap lookup → cost schedule.
        → (Placement, hashes, per-worker overlap scores, eligible
        workers, directory runs). Raises NoInstancesError when no
        candidate.

        ``adapter_id`` salts the block hashes (tokens.adapter_hash_seed)
        exactly as the engines do, so stickiness and overlap scoring are
        keyed by (model, adapter): a conversation lands where both its KV
        prefix AND its adapter are warm, and an identical prompt under a
        different adapter can never ride another identity's cache."""
        t0 = time.perf_counter() if self._m else 0.0
        bs = self.config.block_size
        hashes = compute_block_hashes(token_ids, bs, adapter_hash_seed(adapter_id))
        request_blocks = max(1, (len(token_ids) + bs - 1) // bs)
        k = self.config.shortlist_k
        if k > 0:
            # Shortlist mode: amortize the O(fleet) discovery scan behind
            # a (version, TTL)-keyed roster cache and keep the
            # ActiveSequences idle heap synced to it.
            v = self.discovery.version
            now = time.monotonic()
            if v != self._roster_version or now - self._roster_stamp > _ROSTER_TTL_S:
                self._roster = self.discovery.instance_ids()
                self._roster_set = set(self._roster)
                self._roster_version = v
                self._roster_stamp = now
                self.active.sync_roster(self._roster)
            if excluded:
                workers = [w for w in self._roster if w not in excluded]
                eligible_set = set(workers)
            else:
                workers = self._roster
                eligible_set = self._roster_set
        else:
            workers = [w for w in self.discovery.instance_ids() if w not in excluded]
            eligible_set = None  # legacy membership checks scan the list
        if not workers:
            raise NoInstancesError("no available instances")
        overlaps = self.index.find_matches(hashes, top_k=k)
        if self.decisions is not None:
            # Cross-process stickiness: a sibling's published placement is
            # an overlap FLOOR fed to the same cost schedule — a deeper
            # live-index match still wins, and a dead/excluded worker is
            # simply not boosted (the index can't vouch for the cache).
            cached = self.decisions.lookup(hashes)
            if cached is not None:
                wid, depth = cached
                member = wid in (eligible_set if eligible_set is not None else workers)
                if member and depth > overlaps.scores.get(wid, 0):
                    overlaps.scores[wid] = depth
        # Would the scheduler actually prune? (Mirrors its own predicate.)
        prune = (
            k > 0
            and len(workers) > k + self.config.least_loaded_m
            and self.active.roster_size() > 0
        )
        dir_runs: dict[int, int] = {}
        fetchable: dict[int, int] | None = None
        fetch_default = 0
        if self.directory is not None:
            dir_runs = {
                wid: d for wid, d in self.directory.best_runs(hashes).items()
                if wid not in excluded
            }
            if dir_runs:
                for wid, d in dir_runs.items():
                    # Own holdings floor the overlap: the live index only
                    # mirrors G1 events, the directory also knows the
                    # worker's G2-G4 (and drained-in) residency. (Only
                    # listed holders can floor — everyone else's run is 0.)
                    member = wid in (eligible_set if eligible_set is not None else workers)
                    if member and d > overlaps.scores.get(wid, 0):
                        overlaps.scores[wid] = d
                # Per-candidate transferable depth: the deepest run some
                # OTHER holder (any pool — a prefill-role engine serves
                # kv_prefix too) could stream to it.
                if prune:
                    # O(holders): for any worker, max-over-others is the
                    # global best run — or the second best if the worker
                    # IS the best holder. Non-holders take fetch_default.
                    top1_w, top1_d, top2_d = 0, 0, 0
                    for wid, d in dir_runs.items():
                        if d > top1_d:
                            top2_d, top1_d, top1_w = top1_d, d, wid
                        elif d > top2_d:
                            top2_d = d
                    fetch_default = top1_d
                    fetchable = {}
                    for wid in dir_runs:
                        if wid in eligible_set:
                            peer = top2_d if wid == top1_w else top1_d
                            if peer:
                                fetchable[wid] = peer
                    fetchable = fetchable or None
                else:
                    fetchable = {}
                    for w in workers:
                        peer = max(
                            (d for wid, d in dir_runs.items() if wid != w),
                            default=0,
                        )
                        if peer:
                            fetchable[w] = peer
                    fetchable = fetchable or None
        placement = self.scheduler.schedule(
            workers, request_blocks, overlaps, self.active, fetchable=fetchable,
            workers_set=eligible_set, fetch_default=fetch_default,
        )
        if self._m:
            h = self._m.get("place_seconds")
            if h is not None:
                h.observe(time.perf_counter() - t0)
            c = self._m.get("candidates_considered")
            if c is not None:
                c.inc(placement.candidates_considered)
            if k > 0 and placement.full_scan:
                f = self._m.get("shortlist_fallback")
                if f is not None:
                    f.inc()
        return placement, hashes, overlaps.scores, workers, dir_runs

    def _peer_hint(self, placement, scores: dict[int, int],
                   eligible: list[int],
                   dir_runs: dict[int, int] | None = None) -> dict | None:
        """G4 cross-worker reuse hint: the workers holding the most extra
        prefix blocks relative to the chosen placement, if the gap clears
        ``peer_fetch_min_blocks``. Index-scored candidates are filtered
        to ``eligible`` (the index can lag discovery); directory-listed
        holders are lease-live by construction and may sit in OTHER pools
        (a prefill-role or draining engine serves kv_prefix too, so it
        need not be in the placement set). The hint carries every viable
        holder deepest-first — the fetcher fails over down the list —
        plus the legacy single-holder fields."""
        m = self.config.peer_fetch_min_blocks
        if m <= 0:
            return None
        live = set(eligible)
        cand: dict[int, int] = {}
        for wid, overlap in scores.items():
            if wid != placement.worker and wid in live:
                cand[wid] = max(cand.get(wid, 0), int(overlap))
        for wid, depth in (dir_runs or {}).items():
            if wid != placement.worker:
                cand[wid] = max(cand.get(wid, 0), int(depth))
        floor = placement.overlap_blocks + m
        ranked = sorted(
            ((d, wid) for wid, d in cand.items() if d >= floor), reverse=True
        )
        if not ranked:
            return None
        holders = [
            {"instance_id": wid, "num_blocks": d} for d, wid in ranked[:3]
        ]
        return {**holders[0], "holders": holders}

    def find_best_match(self, token_ids: list[int],
                        adapter_id: str | None = None) -> tuple[int, int]:
        """→ (worker_instance_id, overlap_blocks) without routing — the
        reference's `query_instance_id` surface (kv_router.rs:225-264)."""
        placement, _, _, _, _ = self._place(token_ids, adapter_id=adapter_id)
        return placement.worker, placement.overlap_blocks

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        token_ids = list(request.get("token_ids") or []) if isinstance(request, dict) else []
        adapter_id = request.get("adapter_id") if isinstance(request, dict) else None

        if isinstance(request, dict) and request.get("annotations", {}).get("query_instance_id"):
            wid, overlap = self.find_best_match(token_ids, adapter_id)
            yield {"worker_instance_id": wid, "overlap_blocks": overlap}
            return

        attempts = 0
        excluded: set[int] = set()
        last_err: Exception | None = None
        # KV transfer state the CALLER attached (disagg inject/export)
        # is preserved verbatim; our own peer hint is recomputed per
        # attempt so a retry never carries a stale/failed peer.
        user_ktp = request.get("kv_transfer_params") if isinstance(request, dict) else None
        # Live-migration resume leg: pin the FIRST attempt to the
        # destination that holds the staged KV. A pre-stream failure
        # (destination died after committing) falls through to normal
        # placement — the resume identity rides the request, so any
        # worker serves the leg by re-prefilling, still byte-identical.
        # ``rebind: False`` (dead decision store) skips the stickiness
        # rewrite; otherwise the first frame from the destination
        # rebinds the decision cache atomically below.
        mig_pin = (user_ktp or {}).get("migration_resume") if isinstance(user_ktp, dict) else None
        pin_wid = mig_pin.get("instance") if isinstance(mig_pin, dict) else None
        no_rebind = isinstance(mig_pin, dict) and mig_pin.get("rebind") is False
        while attempts < self.config.max_attempts:
            attempts += 1
            try:
                placement, hashes, scores, eligible, dir_runs = self._place(
                    token_ids, excluded, adapter_id
                )
            except NoInstancesError:
                break
            wid = placement.worker
            if pin_wid is not None:
                if pin_wid in eligible:
                    wid = pin_wid
                pin_wid = None  # the pin governs the first attempt only
            if self.event_sink is not None:
                try:
                    self.event_sink(KVHitRateEvent(
                        worker_id=wid,
                        isl_blocks=placement.total_blocks,
                        overlap_blocks=placement.overlap_blocks,
                    ))
                except Exception:  # noqa: BLE001 — observability never breaks routing
                    log.exception("hit-rate event sink failed")
            if isinstance(request, dict):
                request = dict(request)
                request["estimated_prefix_hit_num_blocks"] = (
                    placement.overlap_blocks if wid == placement.worker
                    else int(scores.get(wid, 0))
                )
                if user_ktp:
                    request["kv_transfer_params"] = user_ktp
                else:
                    hint = self._peer_hint(placement, scores, eligible, dir_runs)
                    request["kv_transfer_params"] = (
                        {"peer_prefix": hint} if hint is not None else None
                    )
                    if (
                        self.directory is not None
                        and "transfer_choices" in self._m
                        and 0 < self.config.peer_fetch_min_blocks
                        <= placement.total_blocks - placement.overlap_blocks
                    ):
                        # Economy outcome for a non-trivially-missing
                        # prefix: pull it from a holder, or prefill it.
                        self._m["transfer_choices"].inc(
                            choice="transfer" if hint else "recompute"
                        )
            self.active.add_request(
                context.id, wid, placement.total_blocks, placement.overlap_blocks, len(token_ids)
            )
            if isinstance(self.index, ApproxKvIndexer):
                self.index.record_routing(wid, hashes)
            first = True
            stream = self.push.generate(request, context, instance_id=wid)
            try:
                async for item in stream:
                    if first:
                        first = False
                        self.active.mark_prefill_complete(context.id)
                        if self.decisions is not None and not no_rebind:
                            # Publish only once the stream started: the
                            # worker demonstrably accepted the request,
                            # so its cache really holds this prefix. For
                            # a migration resume leg this IS the atomic
                            # stickiness rebind to the destination.
                            self.decisions.record(hashes, wid)
                    yield item
                return
            except (
                NoInstancesError,  # worker vanished between placement and dispatch
                TruncatedStreamError,
                NoHandlerError,
                OverloadedError,  # admission-gate refusal: place on next-best
                ConnectionError,
                OSError,
            ) as e:
                last_err = e
                if not first:
                    raise  # mid-stream death: Migration's responsibility
                log.warning("kv route to %x failed pre-stream: %s", wid, e)
                excluded.add(wid)
                continue
            finally:
                self.active.free(context.id)
                # Deterministic close: an abandoned inner stream must run its
                # finallys (span end, wire cancel) now, not at async-GC.
                await stream.aclose()
        raise last_err or NoInstancesError("no available instances")
