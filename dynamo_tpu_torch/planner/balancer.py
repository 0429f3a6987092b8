"""Fleet hot-spot balancer: live migration as a CONTINUOUS policy.

The migration mechanism (worker/migrate.py: streamed KV + bounded
cutover, byte-identical under chaos) relocated only
when *told to* — planner pool moves, retirement, QoS preemption. This
module closes ROADMAP item 3's remainder: decide WHEN to migrate without
being told (Llumnix's thesis, arXiv 2406.03243 — migration as the
scheduling primitive), so a saturated engine sheds decodes to idle
siblings instead of stretching every resident stream's ITL.

Split exactly like planner/operator.py:

- :class:`BalancerLaw` — the pure decision core. Deterministic and
  clock-injected, so the 120-engine discrete-event bench
  (benchmarks/diurnal.py --balancer) and the unit suite drive the EXACT
  production decision code.
- :class:`FleetBalancer` — the async shell: observes per-engine load off
  the existing ``load_metrics`` plane, actuates through ``workerctl
  migrate_out`` admin RPCs, roots a ``planner.balance`` span per move
  and counts every outcome.

Control law (docs/autoscaler.md#fleet-balancer has the derivation):
each engine's **load score** blends batch-depth fraction, KV-pool usage
and queue depth. A move is proposed from the hottest engine above
``saturation`` to the coldest below ``idle`` when the score gap exceeds
``min_gap`` — or, independently of batch depth, when KV usage crosses
``kv_pressure`` (proactive defrag: shed BEFORE the engine is forced to
preempt). Stability is triple-gated:

- **hysteresis** — the same (src, dst) pair must win for
  ``hysteresis_cycles`` consecutive cycles before it actuates;
- **per-pair cooldown** — an actuated pair (both directions) is frozen
  for ``pair_cooldown_s``;
- **destination settling** — an engine that just RECEIVED a sequence
  cannot become a source for ``settle_s``. Combined with the reverse
  -pair cooldown this is the zero-ping-pong guarantee: no sequence can
  be migrated twice within min(settle_s, pair_cooldown_s), because its
  new home is barred from shedding anything for that window.

Failure model: a failed or typed-refused move (victimless engine, paced
source, dead destination) drops the proposal — hysteresis restarts from
live scores next cycle — and never opens a cooldown, so the balancer
retries without hammering. The migration mechanism underneath already
degrades every mid-move death to a completed stream (typed fallback),
so a bad balancer decision costs bandwidth, never correctness.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.planner.actions import POOL_DECODE
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.balancer")

REASON_HOT_SPOT = "hot_spot"
REASON_KV_PRESSURE = "kv_pressure"


def status_key(operator_id: str) -> str:
    """Store key the balancer publishes its decision state under —
    lease-attached to the operator (dies with it), read by the fleet
    supervisor's ``GET /fleet`` as its ``balancer`` block."""
    return f"planner/{operator_id}/balancer"


@dataclass
class BalancerConfig:
    # Load-score blend. Batch-depth fraction is the primary ITL proxy
    # (continuous batching: every resident stream pays for depth), KV
    # usage is the preemption-risk proxy, queue depth the TTFT proxy.
    batch_weight: float = 0.5
    kv_weight: float = 0.3
    queue_weight: float = 0.2
    # Thresholds on the blended score (0..1 scale).
    saturation: float = 0.75   # a source must score above this
    idle: float = 0.45         # a destination must score below this
    min_gap: float = 0.25      # and the pair's score gap must exceed this
    # Proactive defrag: KV usage alone (regardless of batch score)
    # qualifies an engine as a source — relocate the cheapest victim
    # BEFORE the preemption boundary forces the choice.
    kv_pressure: float = 0.85
    # Stability gates (mirrors OperatorConfig's law knobs).
    hysteresis_cycles: int = 2
    pair_cooldown_s: float = 30.0
    # An engine that just received a migrated sequence may not become a
    # source for this long — the zero-ping-pong window.
    settle_s: float = 30.0
    max_moves_per_cycle: int = 1


@dataclass(frozen=True)
class EngineLoad:
    """One engine's load snapshot (a ForwardPassMetrics distillation)."""

    instance_id: int
    active: int        # running sequences (request_active_slots)
    slots: int         # batch capacity (request_total_slots)
    waiting: int       # queued admissions (num_requests_waiting)
    kv_usage: float    # KV pool usage fraction (gpu_cache_usage_perc)


@dataclass(frozen=True)
class BalanceMove:
    src: int
    dst: int
    reason: str        # REASON_* label on balancer_moves_total
    src_score: float
    dst_score: float

    def describe(self) -> str:
        src = f"{self.src:x}" if isinstance(self.src, int) else str(self.src)
        dst = f"{self.dst:x}" if isinstance(self.dst, int) else str(self.dst)
        return (
            f"balance[{self.reason}] {src}({self.src_score:.2f}) → "
            f"{dst}({self.dst_score:.2f})"
        )


@dataclass
class BalancerState:
    """Introspectable decision state (surfaced by /fleet + the bench)."""

    moves_proposed: int = 0
    moves_actuated: int = 0
    pingpong_suppressed: int = 0
    holds: dict[str, int] = field(default_factory=dict)


class BalancerLaw:
    """Pure decision core: (per-engine loads, now) → moves."""

    def __init__(self, cfg: BalancerConfig | None = None):
        self.cfg = cfg or BalancerConfig()
        self.state = BalancerState()
        # (src, dst) signature → consecutive-cycle count.
        self._pending: dict[tuple[int, int], int] = {}
        self._pair_cooldown_until: dict[tuple[int, int], float] = {}
        self._settle_until: dict[int, float] = {}

    # -- scoring ------------------------------------------------------------

    def score(self, l: EngineLoad) -> float:
        cfg = self.cfg
        slots = max(l.slots, 1)
        batch = min(l.active / slots, 1.0)
        queue = min(l.waiting / slots, 1.0)
        kv = min(max(l.kv_usage, 0.0), 1.0)
        return cfg.batch_weight * batch + cfg.kv_weight * kv + cfg.queue_weight * queue

    def _hold(self, reason: str) -> None:
        self.state.holds[reason] = self.state.holds.get(reason, 0) + 1

    # -- the decision -------------------------------------------------------

    def decide(self, loads: list[EngineLoad], now: float | None = None) -> list[BalanceMove]:
        """One balance cycle over the decode fleet's load snapshots."""
        now = time.monotonic() if now is None else now
        cfg = self.cfg
        if len(loads) < 2:
            self._pending.clear()
            return []
        scored = sorted(
            ((self.score(l), l) for l in loads), key=lambda t: (t[0], t[1].instance_id)
        )
        moves: list[BalanceMove] = []
        live_pairs: set[tuple[int, int]] = set()
        used: set[int] = set()
        # Greedy pairing: hottest source with coldest destination, then
        # the next pair, up to max_moves_per_cycle.
        hot = [t for t in reversed(scored)]
        cold = list(scored)
        for s_score, src in hot:
            if len(moves) >= cfg.max_moves_per_cycle:
                break
            if src.instance_id in used:
                continue
            kv_hot = src.kv_usage >= cfg.kv_pressure
            if s_score < cfg.saturation and not kv_hot:
                break  # sorted: nothing hotter remains
            if now < self._settle_until.get(src.instance_id, 0.0):
                # Just received a sequence: shedding now could bounce the
                # very sequence we moved in — the ping-pong guard.
                self.state.pingpong_suppressed += 1
                self._hold("settling")
                continue
            dst_pick = None
            for d_score, dst in cold:
                if dst.instance_id in used or dst.instance_id == src.instance_id:
                    continue
                if d_score >= cfg.idle:
                    break  # sorted: nothing colder remains
                if not kv_hot and s_score - d_score < cfg.min_gap:
                    continue
                if now < self._pair_cooldown_until.get(
                    (src.instance_id, dst.instance_id), 0.0
                ):
                    self._hold("cooldown")
                    continue
                dst_pick = (d_score, dst)
                break
            if dst_pick is None:
                self._hold("no_destination")
                continue
            d_score, dst = dst_pick
            pair = (src.instance_id, dst.instance_id)
            live_pairs.add(pair)
            count = self._pending.get(pair, 0) + 1
            self._pending[pair] = count
            if count < cfg.hysteresis_cycles:
                self._hold("hysteresis")
                continue
            reason = REASON_KV_PRESSURE if kv_hot else REASON_HOT_SPOT
            moves.append(BalanceMove(
                src=src.instance_id, dst=dst.instance_id, reason=reason,
                src_score=s_score, dst_score=d_score,
            ))
            used.update(pair)
            self.state.moves_proposed += 1
        # A pair that stopped winning loses its momentum — a proposal
        # must hold for consecutive cycles, not accumulate across gaps.
        for pair in list(self._pending):
            if pair not in live_pairs:
                del self._pending[pair]
        return moves

    def notify_actuated(self, move: BalanceMove, now: float | None = None) -> None:
        """After a SUCCESSFUL move: freeze the pair (both directions) and
        bar the destination from shedding until it settles."""
        now = time.monotonic() if now is None else now
        self._pending.pop((move.src, move.dst), None)
        until = now + self.cfg.pair_cooldown_s
        self._pair_cooldown_until[(move.src, move.dst)] = until
        self._pair_cooldown_until[(move.dst, move.src)] = until
        self._settle_until[move.dst] = now + self.cfg.settle_s
        self.state.moves_actuated += 1

    def notify_failed(self, move: BalanceMove) -> None:
        """A refused/failed move restarts its hysteresis, no cooldown —
        retry against live scores without hammering the same cycle."""
        self._pending.pop((move.src, move.dst), None)

    def forget(self, instance_id: int) -> None:
        """Drop all state touching a departed engine."""
        self._settle_until.pop(instance_id, None)
        for pair in [p for p in self._pending if instance_id in p]:
            del self._pending[pair]
        for pair in [p for p in self._pair_cooldown_until if instance_id in p]:
            del self._pair_cooldown_until[pair]


def load_from_metrics(instance_id: int, m) -> EngineLoad:
    """ForwardPassMetrics → EngineLoad."""
    return EngineLoad(
        instance_id=instance_id,
        active=int(m.worker.request_active_slots),
        slots=int(m.worker.request_total_slots),
        waiting=int(m.worker.num_requests_waiting),
        kv_usage=float(m.kv.gpu_cache_usage_perc),
    )


class FleetBalancer:
    """The async shell around :class:`BalancerLaw`.

    Seams (all injectable — the bench and tests drive fakes):

    - ``pools``: async () → {POOL_*: [WorkerInfo]} (planner/actuate.py
      ``read_pools`` in production); only the decode pool is balanced.
    - ``load_source``: async (instance_id) → ForwardPassMetrics | None —
      one-shot ``load_metrics`` pull; None/error skips the engine this
      cycle (an unreachable engine is neither source nor destination).
    - ``mover``: async (src_instance, dst_instance) → reply dict — the
      ``workerctl migrate_out`` admin RPC (victim auto-picked by the
      source worker; see roles.py ``_migrate_out_cmd``).
    """

    def __init__(self, law: BalancerLaw, pools, load_source, mover,
                 metrics: dict | None = None, clock=time.monotonic,
                 publisher=None):
        self.law = law
        self.pools = pools
        self.load_source = load_source
        self.mover = mover
        self.metrics = metrics
        self._clock = clock
        # Optional async status sink: called with status() after every
        # cycle (production: a lease-attached store put under
        # ``status_key`` so GET /fleet can surface the block).
        self.publisher = publisher
        self.moves_done: list[tuple[BalanceMove, str]] = []
        self._pingpong_reported = 0

    async def observe(self) -> list[EngineLoad]:
        pools = await self.pools()
        members = pools.get(POOL_DECODE, [])
        snaps = await asyncio.gather(
            *(self.load_source(w.instance_id) for w in members),
            return_exceptions=True,
        )
        loads: list[EngineLoad] = []
        for w, snap in zip(members, snaps):
            if isinstance(snap, BaseException) or snap is None:
                continue
            loads.append(load_from_metrics(w.instance_id, snap))
        return loads

    async def step(self) -> list[BalanceMove]:
        loads = await self.observe()
        moves = self.law.decide(loads, now=self._clock())
        for move in moves:
            await self._actuate(move)
        self._sync_metrics()
        if self.publisher is not None:
            try:
                await self.publisher(self.status())
            except Exception as e:  # noqa: BLE001 — the status surface is advisory; a store hiccup must not stall rebalancing
                log.debug("balancer status publish failed: %s", e)
        return moves

    async def _actuate(self, move: BalanceMove) -> None:
        # One root span per move (as the planner's actions have): the
        # source worker's migrate_out fan-out stitches under it in the
        # fleet-assembled timeline.
        span = tracing.start_span(
            "planner.balance",
            src=f"{move.src:x}", dst=f"{move.dst:x}", reason=move.reason,
        )
        outcome = "ok"
        try:
            reply = await self.mover(move.src, move.dst)
            if not isinstance(reply, dict) or not reply.get("ok"):
                outcome = "refused"
                detail = (reply or {}).get("reason") or (reply or {}).get("error") \
                    if isinstance(reply, dict) else str(reply)
                span.set_attr("refused", str(detail))
        except asyncio.CancelledError:
            span.end(status="cancelled")
            raise
        except Exception as e:  # noqa: BLE001 — a dead source/destination is an expected chaos outcome; the balancer re-plans from live scores next cycle
            outcome = "error"
            span.set_attr("error", f"{type(e).__name__}: {e}")
        if outcome == "ok":
            self.law.notify_actuated(move, now=self._clock())
            log.info("actuated: %s", move.describe())
        else:
            self.law.notify_failed(move)
            log.warning("move %s: %s", outcome, move.describe())
        if self.metrics is not None:
            self.metrics["moves"].inc(reason=move.reason, outcome=outcome)
        self.moves_done.append((move, outcome))
        span.end(status=None if outcome == "ok" else outcome)

    def _sync_metrics(self) -> None:
        if self.metrics is None:
            return
        delta = self.law.state.pingpong_suppressed - self._pingpong_reported
        if delta > 0:
            self.metrics["pingpong"].inc(delta)
            self._pingpong_reported = self.law.state.pingpong_suppressed

    def status(self) -> dict:
        """The /fleet debug surface's balancer block."""
        s = self.law.state
        return {
            "moves_proposed": s.moves_proposed,
            "moves_actuated": s.moves_actuated,
            "pingpong_suppressed": s.pingpong_suppressed,
            "holds": dict(s.holds),
        }


def build_fleet_balancer(
    runtime, namespace: str, component: str,
    law: BalancerLaw | None = None, metrics: dict | None = None,
    operator_id: str = "default",
) -> "_FleetBalancerBuilder":
    """Wire a FleetBalancer over a live runtime: lease-backed pool
    membership, DIRECT ``load_metrics`` pulls, ``workerctl migrate_out``
    actuation, and per-cycle status publication under
    ``planner/<operator_id>/balancer``. Returns an awaitable builder so
    callers control when the routers bind."""
    return _FleetBalancerBuilder(
        runtime, namespace, component, law, metrics, operator_id
    )


class _FleetBalancerBuilder:
    def __init__(self, runtime, namespace, component, law, metrics,
                 operator_id="default"):
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.law = law or BalancerLaw()
        self.metrics = metrics
        self.operator_id = operator_id

    async def build(self) -> FleetBalancer:
        from dynamo_tpu_torch.kv_router.publisher import LOAD_METRICS_ENDPOINT
        from dynamo_tpu_torch.planner.actuate import read_pools
        from dynamo_tpu_torch.runtime.engine import Context
        from dynamo_tpu_torch.runtime.push_router import RouterMode
        from dynamo_tpu_torch.worker.roles import ADMIN_COMPONENT, ADMIN_ENDPOINT

        ns = self.runtime.namespace(self.namespace)
        load_router = await ns.component(self.component).endpoint(
            LOAD_METRICS_ENDPOINT
        ).router(RouterMode.DIRECT)
        admin_router = await ns.component(ADMIN_COMPONENT).endpoint(
            ADMIN_ENDPOINT
        ).router(RouterMode.DIRECT)
        store = self.runtime.store

        async def pools():
            return await read_pools(store, self.namespace)

        async def load_source(instance_id: int):
            from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics

            snap = None
            ctx = Context.with_timeout(5.0)
            async for item in load_router.generate({}, ctx, instance_id=instance_id):
                snap = item
            return None if snap is None else ForwardPassMetrics.from_dict(snap)

        async def mover(src: int, dst: int) -> dict:
            last: dict = {}
            async for frame in admin_router.generate(
                {"cmd": "migrate_out", "dest_instance": dst}, Context(),
                instance_id=src,
            ):
                if isinstance(frame, dict):
                    last = frame
            return last

        lease_id = await self.runtime.primary_lease()
        key = status_key(self.operator_id)

        async def publisher(status: dict) -> None:
            await store.put(
                key, json.dumps(status).encode(), lease_id=lease_id
            )

        return FleetBalancer(
            self.law, pools, load_source, mover, metrics=self.metrics,
            publisher=publisher,
        )


def register_balancer_metrics(registry) -> dict:
    """The balancer's observability series (DT006-cataloged)."""
    return {
        "moves": registry.counter(
            "balancer_moves_total",
            "Rebalance migrations issued by the fleet balancer, "
            "by reason and outcome",
        ),
        "pingpong": registry.counter(
            "balancer_pingpong_suppressed_total",
            "Balancer moves suppressed because the source was still "
            "settling from a just-received migration",
        ),
    }
