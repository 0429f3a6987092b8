"""Global admission budget: fleet-wide inflight bound, leased in chunks.

Problem: N frontend processes each run a local
:class:`~dynamo_tpu_torch.runtime.admission.AdmissionController`, but the
operator configures ONE number — the total concurrent requests the
cluster should accept. A per-request store round-trip would put the
control plane on the hot path; instead the budget is divided into
fixed **chunks** and processes lease whole chunks:

- chunk ``k`` is the store key ``fleet/<fleet_id>/budget/<k>``;
- a claim is a ``PutMode.CREATE`` under the claimant's primary lease —
  create-if-absent is atomic in the store, so a chunk has at most one
  holder *by construction* (no coordinator, no read-modify-write race);
- a process admits at most ``sum(held chunk slots)`` requests, so the
  fleet-wide admitted total can never exceed the budget;
- a crashed process's lease expires (TTL; the TCP store additionally
  revokes connection-owned leases on disconnect) → its chunk keys
  vanish → siblings see the DELETE events and re-claim the capacity.

Claiming is demand-driven and work-conserving: a process keeps roughly
``inflight + queued`` slots plus half a chunk of headroom, releases the
rest, and re-claims when its queue backs up or a sibling releases.

Multi-tenant QoS generalizes the scheme to **per-class pools** under the
same protocol: the total splits into one chunk namespace per priority
class (``fleet/<id>/budget/<class>/<k>``), so fleet-wide *per-class*
admitted caps hold by construction exactly like the global bound. Work-
conserving borrowing is downward-only and happens HERE, not in the
admission gate: a lower class whose own pool is exhausted runs a
**scavenger** budget against a higher class's pool — claiming its idle
chunks — while **pressure beacons** (``fleet/<id>/pressure/<class>/``)
make it back off: any process whose own-class demand outruns its claims
publishes a beacon, and every scavenger of that pool stops borrowing
and shrinks back to its in-use slots. Idle interactive capacity flows
to batch; interactive under pressure reclaims it; the reverse direction
never borrows.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import json

from dynamo_tpu_torch.runtime.admission import AdmissionController
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.qos import DEFAULT_CLASS, QosPolicy
from dynamo_tpu_torch.runtime.store import EventKind, KeyExistsError, KeyValueStore, PutMode

log = get_logger("fleet.budget")


def budget_prefix(fleet_id: str, qos: str | None = None) -> str:
    """Chunk-key namespace: the legacy single pool, or one pool per QoS
    class. The class pools nest under the legacy prefix so the
    supervisor's chunk accounting covers both layouts."""
    base = f"fleet/{fleet_id}/budget/"
    return base if qos is None else f"{base}{qos}/"


def pressure_prefix(fleet_id: str, qos: str) -> str:
    """Demand beacons: a process starved for ``qos``-class chunks keeps
    a lease-backed key here; scavengers of that pool back off while any
    beacon exists (borrowed capacity returns under donor pressure)."""
    return f"fleet/{fleet_id}/pressure/{qos}/"


def split_class_budget(total: int, shares: dict[str, int]) -> dict[str, int]:
    """Partition ``total`` slots across classes proportionally to
    ``shares`` (largest-remainder rounding; every positive-share class
    gets ≥ 1 slot when total allows, so no class is structurally shut
    out of its own pool)."""
    pos = {c: s for c, s in shares.items() if s > 0}
    if total <= 0 or not pos:
        return {c: 0 for c in shares}
    ssum = sum(pos.values())
    raw = {c: total * s / ssum for c, s in pos.items()}
    out = {c: int(raw[c]) for c in pos}
    # Floor every positive share at 1 first, then largest remainders.
    for c in pos:
        if out[c] == 0 and sum(out.values()) < total:
            out[c] = 1
    rema = sorted(pos, key=lambda c: raw[c] - int(raw[c]), reverse=True)
    i = 0
    while sum(out.values()) < total:
        out[rema[i % len(rema)]] += 1
        i += 1
    while sum(out.values()) > total:  # the ≥1 floors may overshoot tiny totals
        big = max(out, key=lambda c: out[c])
        out[big] -= 1
    return {c: out.get(c, 0) for c in shares}


def chunk_sizes(total: int, chunk_slots: int) -> list[int]:
    """Partition ``total`` slots into chunks of ``chunk_slots`` (the last
    chunk takes the remainder)."""
    if total <= 0:
        return []
    chunk_slots = max(1, min(chunk_slots, total))
    sizes = [chunk_slots] * (total // chunk_slots)
    if total % chunk_slots:
        sizes.append(total % chunk_slots)
    return sizes


class GlobalBudget:
    """One process's view of the shared budget: claims/releases chunks to
    track local demand, reports held slots through ``on_change``."""

    def __init__(
        self,
        store: KeyValueStore,
        fleet_id: str,
        lease_id: int,
        total: int,
        chunk_slots: int = 8,
        worker_id: int = 0,
        on_change=None,
        demand_fn=None,
        metrics: dict | None = None,
        qos: str | None = None,
        headroom: bool = True,
        pressure_beacon: bool = False,
        yield_prefix: str | None = None,
        in_use_fn=None,
        labels: dict | None = None,
    ):
        self.store = store
        self.fleet_id = fleet_id
        self.lease_id = lease_id
        self.total = total
        self.sizes = chunk_sizes(total, chunk_slots)
        self.chunk_slots = max(1, min(chunk_slots, total)) if total > 0 else chunk_slots
        # QoS class pools: chunks live under a per-class prefix so the
        # ≤1-holder-per-chunk protocol bounds each class independently.
        self.qos = qos
        self.prefix = budget_prefix(fleet_id, qos)
        # Scan order starts at a per-worker offset so siblings claiming
        # concurrently mostly probe disjoint chunks (fewer CREATE losses).
        n = len(self.sizes)
        self.scan_order = [(worker_id * (n // 2 + 1) + i) % n for i in range(n)]
        self.on_change = on_change
        # demand_fn() → slots this process currently needs (inflight +
        # queued); the manager keeps held ≈ demand + headroom.
        self.demand_fn = demand_fn or (lambda: 0)
        # Scavenger mode (downward borrowing): no headroom — a borrower
        # claims exactly its overflow demand and nothing speculative.
        self.headroom = headroom
        # Pressure beacon (primary class pools): publish a lease-backed
        # key while own-class demand outruns claims, so scavengers of
        # this pool back off fleet-wide.
        self._beacon_key = (
            pressure_prefix(fleet_id, qos) + str(worker_id)
            if pressure_beacon and qos is not None
            else None
        )
        self._beacon_up = False
        # Yield watch (scavengers): while ANY pressure beacon exists for
        # the donor pool, stop borrowing and shrink to in-use slots.
        self.yield_prefix = yield_prefix
        self._yielding = False
        self._yield_watch = None
        self._yield_task: asyncio.Task | None = None
        # in_use_fn() → slots of this budget's holdings currently
        # OCCUPIED by admitted requests (a yielding scavenger can only
        # shrink to this — releasing an in-use chunk would let the donor
        # class admit on top of running borrowed work).
        self.in_use_fn = in_use_fn or (lambda: 0)
        self._mlabels = dict(labels or {})
        self.held: dict[int, int] = {}  # chunk index → slots
        # Store revision of each chunk's claim put: a DELETE event older
        # than our claim is the stale echo of an earlier release (ours or
        # a sibling's) arriving after a re-claim — acting on it would
        # discard a live claim and leak the chunk's slots fleet-wide.
        self._claim_rev: dict[int, int] = {}
        self._poke = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._draining = False
        self._closed = False
        self._m = metrics or {}

    @property
    def held_slots(self) -> int:
        return sum(self.held.values())

    def poke(self) -> None:
        """Nudge the manager to re-evaluate claims (called from the
        admission gate's acquire/release paths — cheap, loop-local)."""
        self._poke.set()

    def start_draining(self) -> None:
        """Drain mode: stop claiming; release down to live demand as
        in-flight streams finish (never below — released capacity gets
        admitted by siblings immediately, and fleet-wide admitted must
        stay ≤ budget)."""
        self._draining = True
        self._poke.set()

    async def start(self) -> "GlobalBudget":
        loop = asyncio.get_running_loop()
        self._watch = await self.store.watch_prefix(self.prefix)
        self._watch_task = loop.create_task(self._watch_loop())
        if self.yield_prefix is not None:
            await self._refresh_yielding()
            self._yield_watch = await self.store.watch_prefix(self.yield_prefix)
            self._yield_task = loop.create_task(self._yield_loop())
        await self._rebalance()  # claim the initial headroom chunk
        self._task = loop.create_task(self._manage_loop())
        return self

    async def close(self) -> None:
        """Release every held chunk and stop. Part of the drain contract:
        a SIGTERM'd process must return its budget explicitly rather than
        leaving siblings to wait out the lease TTL."""
        if self._closed:
            return
        self._closed = True
        for t in (self._task, self._watch_task, self._yield_task):
            if t is not None:
                t.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await t
        if self._watch is not None:
            await self._watch.cancel()
        if self._yield_watch is not None:
            await self._yield_watch.cancel()
        if self._beacon_up:
            with contextlib.suppress(Exception):
                await self.store.delete(self._beacon_key)
            self._beacon_up = False
        for idx in list(self.held):
            await self._release(idx)
        self._report()

    async def _refresh_yielding(self) -> None:
        try:
            entries = await self.store.get_prefix(self.yield_prefix)
        except Exception as e:  # noqa: BLE001 — store hiccup: keep the last-known pressure state; the next event retries
            log.warning("pressure read failed: %s", e)
            return
        was = self._yielding
        self._yielding = bool(entries)
        if self._yielding != was:
            log.info(
                "scavenger %s: donor pressure %s", self.prefix,
                "up — yielding borrowed chunks" if self._yielding else "cleared",
            )
            self._poke.set()

    async def _yield_loop(self) -> None:
        # Donor-pool pressure beacons appearing/vanishing flip borrow
        # eligibility; re-read the prefix on every event (rare, cheap).
        try:
            async for _ev in self._yield_watch:
                await self._refresh_yielding()
        except asyncio.CancelledError:
            pass

    async def _watch_loop(self) -> None:
        # A sibling releasing (or dying: lease expiry deletes its keys)
        # frees capacity this process may be queued for — re-claim.
        try:
            async for ev in self._watch:
                if ev.kind != EventKind.DELETE:
                    continue
                tail = ev.key.rsplit("/", 1)[1]
                if (
                    tail.isdigit()
                    and int(tail) in self.held
                    # Revision guard: only a DELETE newer than our claim
                    # means OUR key vanished server-side (lease expired —
                    # keepalive fell behind TTL). Older DELETEs are stale
                    # echoes of pre-re-claim releases.
                    and ev.revision > self._claim_rev.get(int(tail), -1)
                ):
                    idx = int(tail)
                    log.warning("budget chunk %d lost to lease expiry", idx)
                    self.held.pop(idx, None)
                    self._claim_rev.pop(idx, None)
                    # A sibling may claim it now: shrink the local limit
                    # immediately — the fleet-wide bound outranks this
                    # process's capacity.
                    self._report()
                self._poke.set()
        except asyncio.CancelledError:
            pass

    async def _manage_loop(self) -> None:
        loop = asyncio.get_running_loop()
        # Pokes (queue pressure, sibling releases) trigger fast claim
        # passes; releases happen on a 1s PERIODIC tick so a
        # sporadically-loaded process can't flap a chunk per request —
        # and the tick must fire under steady traffic too (every request
        # completion pokes, so gating release on a quiet second would
        # never return surplus while serving). Draining releases eagerly.
        next_release = loop.time() + 1.0
        try:
            while True:
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._poke.wait(), max(0.05, next_release - loop.time())
                    )
                self._poke.clear()
                release = self._draining or loop.time() >= next_release
                if release:
                    next_release = loop.time() + 1.0
                await self._rebalance(release=release)
        except asyncio.CancelledError:
            pass

    def _desired_slots(self) -> int:
        demand = max(0, int(self.demand_fn()))
        if not self.headroom:
            # Scavenger: claim exactly the overflow demand, FLOORED at
            # what borrowed admissions still occupy — whether yielding,
            # draining, or just past the borrow spike, releasing a chunk
            # that running borrowed work stands on would let the donor
            # class admit on top of it and break the per-pool cap.
            in_use = max(0, int(self.in_use_fn()))
            if self._yielding:
                # Donor-class pressure somewhere in the fleet: stop
                # borrowing MORE; shrink to occupancy only.
                return in_use
            return max(demand, in_use)
        if self._yielding:
            return min(demand, max(0, int(self.in_use_fn())))
        if self._draining:
            return demand  # never below in-flight; no headroom either
        if self.qos is not None and demand <= 0:
            # An IDLE class pool holds nothing: its chunks must be
            # borrowable by lower classes (work conservation), and the
            # class's own first burst pays exactly one claim RTT — the
            # same price the legacy pool charges a starved claim.
            return 0
        # Half a chunk of headroom keeps claim latency off the hot path
        # while bounding what an idle process withholds from loaded
        # siblings (work conservation beats first-burst latency here —
        # a starved claim costs ~1 store round-trip).
        return demand + max(1, self.chunk_slots // 2)

    async def _rebalance(self, release: bool = True) -> None:
        desired = self._desired_slots()
        # Claim up: any unheld chunk, in this worker's scan order.
        while self.held_slots < desired:
            if not await self._claim_one():
                break
        if release:
            # Release down: whole chunks whose loss still leaves desired.
            while self.held:
                idx = next(reversed(self.held))
                if self.held_slots - self.held[idx] < desired:
                    break
                await self._release(idx)
        await self._update_beacon(desired)
        self._report()

    async def _update_beacon(self, desired: int) -> None:
        """Pressure beacon (primary class pools): up while own-class
        demand outruns what this process could claim — the signal that
        makes every scavenger of this pool yield its borrowed chunks."""
        if self._beacon_key is None:
            return
        starved = (
            not self._draining
            and max(0, int(self.demand_fn())) > self.held_slots
        )
        if starved == self._beacon_up:
            return
        try:
            if starved:
                await self.store.put(
                    self._beacon_key, b"1", lease_id=self.lease_id
                )
            else:
                await self.store.delete(self._beacon_key)
            self._beacon_up = starved
        except Exception as e:  # noqa: BLE001 — beacon is an optimization signal: a missed flip self-heals on the next rebalance (and the lease TTL clears stale beacons)
            log.warning("pressure beacon update failed: %s", e)

    async def _claim_one(self) -> bool:
        payload = None
        for idx in self.scan_order:
            if idx in self.held:
                continue
            if payload is None:
                payload = json.dumps({"lease": self.lease_id}).encode()
            key = self.prefix + str(idx)
            try:
                rev = await self.store.put(
                    key, payload, lease_id=self.lease_id, mode=PutMode.CREATE
                )
            except KeyExistsError:
                continue
            except Exception as e:  # noqa: BLE001 — store hiccup: claim retried on next poke/tick, never crashes admission
                log.warning("budget claim failed: %s", e)
                if "claims" in self._m:
                    self._m["claims"].inc(outcome="error", **self._mlabels)
                return False
            self.held[idx] = self.sizes[idx]
            self._claim_rev[idx] = rev
            if "claims" in self._m:
                self._m["claims"].inc(outcome="won", **self._mlabels)
            return True
        if "claims" in self._m:
            self._m["claims"].inc(outcome="exhausted", **self._mlabels)
        return False

    async def _release(self, idx: int) -> None:
        self.held.pop(idx, None)
        self._claim_rev.pop(idx, None)
        # Lower the LOCAL limit before the awaited delete publishes the
        # capacity to siblings: the store round-trip yields the event
        # loop, and an acquire() racing in against the stale higher
        # limit while a sibling claims the chunk would put fleet-wide
        # admitted over the budget.
        self._report()
        try:
            await self.store.delete(self.prefix + str(idx))
        except Exception as e:  # noqa: BLE001 — release is best-effort: the lease TTL reclaims the chunk if the delete is lost
            log.warning("budget release failed: %s", e)

    def _report(self) -> None:
        if "slots" in self._m:
            self._m["slots"].set(self.held_slots, **self._mlabels)
        if "chunks" in self._m:
            self._m["chunks"].set(len(self.held), **self._mlabels)
        if self.on_change is not None:
            self.on_change(self.held_slots)


class BudgetedAdmissionController(AdmissionController):
    """Admission gate whose capacity is whatever the process currently
    leases from the :class:`GlobalBudget`. ``max_inflight == 0`` means
    *zero admissions* here (requests queue up to ``max_queue_depth``
    waiting for a chunk claim), not "unlimited" as in the base class."""

    allow_unbounded = False

    def __init__(self, budget: GlobalBudget, **kw):
        kw.setdefault("max_queue_depth", max(32, budget.chunk_slots * 2))
        super().__init__(max_inflight=0, **kw)
        self.budget = budget
        budget.on_change = self.set_limit
        budget.demand_fn = lambda: self._inflight + self.queued

    async def acquire(self, priority: str | None = None) -> str:
        # Nudge the claim loop BEFORE possibly queueing: the queued wait
        # is exactly what a fresh chunk claim resolves.
        if self._inflight + self.queued + 1 > self.max_inflight:
            self.budget.poke()
        return await super().acquire(priority)

    def release(self, qos: str = DEFAULT_CLASS) -> None:
        super().release(qos)
        # Falling demand is what lets chunks flow back to hot siblings.
        self.budget.poke()

    def start_draining(self) -> None:
        super().start_draining()
        self.budget.start_draining()


class ClassBudgetSet:
    """Per-class chunk pools for one process, plus downward borrowing.

    For every class in the policy this process runs a **primary**
    budget on the class's own pool (with a pressure beacon), and for
    every strictly-higher class a headroom-free **scavenger** budget on
    that donor pool which claims only the class's overflow demand and
    yields whenever any fleet member beacons donor-class pressure. The
    admission gate's per-class caps are simply ``primary.held +
    Σ scavenged.held`` — every admitted request is backed by a leased
    chunk of SOME pool, so each pool's fleet-wide cap holds by
    construction and borrowing never needs gate-side logic."""

    def __init__(
        self,
        store: KeyValueStore,
        fleet_id: str,
        lease_id: int,
        totals: dict[str, int],
        policy: QosPolicy,
        chunk_slots: int = 8,
        worker_id: int = 0,
        metrics: dict | None = None,
        borrow: bool = True,
    ):
        self.policy = policy
        self.totals = dict(totals)
        self.chunk_slots = chunk_slots
        self.ctl: AdmissionController | None = None
        self.primary: dict[str, GlobalBudget] = {}
        self.scav: dict[str, list[GlobalBudget]] = {c: [] for c in policy.order}
        for cls in policy.order:
            self.primary[cls] = GlobalBudget(
                store, fleet_id, lease_id, total=totals.get(cls, 0),
                chunk_slots=chunk_slots, worker_id=worker_id,
                on_change=self._changed, metrics=metrics,
                demand_fn=functools.partial(self._class_demand, cls),
                qos=cls, pressure_beacon=True, labels={"class": cls},
            )
        if borrow:
            for cls in policy.order:
                donors = [
                    d for d in policy.order if policy.rank(d) > policy.rank(cls)
                ]
                # Nearest-rank donor first: batch drains standard's idle
                # pool before touching interactive's.
                for donor in sorted(donors, key=policy.rank):
                    self.scav[cls].append(GlobalBudget(
                        store, fleet_id, lease_id,
                        total=totals.get(donor, 0),
                        chunk_slots=chunk_slots,
                        # Probe from the far end of the donor's chunk space
                        # so scavengers rarely collide with its own claims.
                        worker_id=worker_id + 13,
                        on_change=self._changed,
                        demand_fn=functools.partial(
                            self._overflow_demand, cls, donor
                        ),
                        in_use_fn=functools.partial(self._borrowed_in_use, cls),
                        qos=donor, headroom=False,
                        yield_prefix=pressure_prefix(fleet_id, donor),
                        labels={"class": f"{cls}<-{donor}"},
                    ))

    def bind(self, ctl: AdmissionController) -> None:
        self.ctl = ctl

    def _all(self) -> list[GlobalBudget]:
        return list(self.primary.values()) + [
            b for lst in self.scav.values() for b in lst
        ]

    def caps(self) -> dict[str, int]:
        return {
            c: self.primary[c].held_slots
            + sum(b.held_slots for b in self.scav[c])
            for c in self.policy.order
        }

    def _changed(self, _slots: int) -> None:
        if self.ctl is not None:
            self.ctl.set_class_caps(self.caps())

    def _class_demand(self, cls: str) -> int:
        if self.ctl is None:
            return 0
        return self.ctl.inflight_in(cls) + self.ctl.queued_in(cls)

    def _overflow_demand(self, cls: str, donor: str) -> int:
        """Demand this class routes at ``donor``'s pool: whatever its
        own pool's HELD slots cannot cover (siblings may hold part of
        the class pool, so the full pool size would undercount real
        overflow — and overcount occupied borrowed chunks as
        releasable), minus what earlier (nearer-rank) donors already
        lend."""
        over = max(
            0, self._class_demand(cls) - self.primary[cls].held_slots
        )
        for b in self.scav[cls]:
            if b.qos == donor:
                break
            over = max(0, over - b.held_slots)
        return over

    def _borrowed_in_use(self, cls: str) -> int:
        """Admitted ``cls`` requests currently standing on borrowed
        chunks — the floor a yielding scavenger may shrink to."""
        if self.ctl is None:
            return 0
        return max(
            0, self.ctl.inflight_in(cls) - self.primary[cls].held_slots
        )

    def poke(self, cls: str | None = None) -> None:
        if cls is None:
            for b in self._all():
                b.poke()
            return
        self.primary[cls].poke()
        for b in self.scav.get(cls, ()):
            b.poke()

    def start_draining(self) -> None:
        for b in self._all():
            b.start_draining()

    async def start(self) -> "ClassBudgetSet":
        for b in self._all():
            await b.start()
        return self

    async def close(self) -> None:
        # Scavengers first: borrowed capacity returns before own pools.
        for lst in self.scav.values():
            for b in lst:
                await b.close()
        for b in self.primary.values():
            await b.close()


class QosBudgetedAdmissionController(AdmissionController):
    """WDRR admission gate whose per-class caps are whatever this
    process currently leases from the per-class pools (plus scavenged
    donor chunks). Every admitted request is chunk-backed, so the
    fleet-wide per-class caps hold by construction."""

    allow_unbounded = False

    def __init__(self, budgets: ClassBudgetSet, **kw):
        kw.setdefault("max_queue_depth", max(32, budgets.chunk_slots * 2))
        kw.setdefault("qos", budgets.policy)
        super().__init__(max_inflight=0, **kw)
        self.budgets = budgets
        budgets.bind(self)
        self.set_class_caps(budgets.caps())

    async def acquire(self, priority: str | None = None) -> str:
        cls = self._resolve(priority)
        # Nudge the class's claim loops (primary + scavengers) BEFORE
        # possibly queueing: the queued wait is exactly what a fresh
        # chunk claim — own-pool or borrowed — resolves.
        if self.inflight_in(cls) + self.queued_in(cls) + 1 > (
            self._class_caps or {}
        ).get(cls, 0):
            self.budgets.poke(cls)
        return await super().acquire(priority)

    def release(self, qos: str = DEFAULT_CLASS) -> None:
        super().release(qos)
        # Falling demand is what lets chunks flow back to hot siblings
        # (and borrowed chunks back to their donor class).
        self.budgets.poke(qos)

    def start_draining(self) -> None:
        super().start_draining()
        self.budgets.start_draining()
