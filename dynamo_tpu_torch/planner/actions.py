"""Typed scale actions: the autoscaler's entire actuation vocabulary.

Every change the closed-loop planner makes to the fleet is one of these
dataclasses — there is no untyped "do something" path. Each action is

- **typed** — consumers route on the class, never on strings
  (``ScaleActionError`` is the one failure type, DT005);
- **metric-counted** — ``planner_scale_actions_total{kind,outcome}``
  increments exactly once per actuation attempt;
- **ledger-traced** — a ``planner.<kind>`` span records the attempt and
  a store journal entry (``planner/<id>/actions/<seq>``) records the
  intent → outcome transition, lease-attached to the operator so a
  crashed operator's journal self-cleans and never leaks keys.

Recovery is LEVEL-based, not journal-replay: a successor operator never
needs a predecessor's in-flight action to converge — it observes the
live pools/fleet and re-plans from scratch (docs/autoscaler.md,
"failure & convergence"). The journal exists for observability.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

# Action kinds (the planner_scale_actions_total{kind} label values).
KIND_FLEET_RESIZE = "fleet_resize"
KIND_POOL_MOVE = "pool_move"
KIND_REPLICA_SCALE = "replica_scale"

# Pool names (the planner_pool_size{pool} label values).
POOL_PREFILL = "prefill"
POOL_DECODE = "decode"
POOLS = (POOL_PREFILL, POOL_DECODE)


class ScaleActionError(Exception):
    """A scale action failed to actuate. The loop records the failure
    (outcome="error") and converges on a later cycle — actuation errors
    are expected under chaos and must never kill the operator."""


@dataclass(frozen=True)
class FleetResize:
    """Resize the frontend fleet: the supervisor grows/shrinks child
    slots through its rolling zero-failure drain (admin RPC)."""

    target: int
    current: int

    kind = KIND_FLEET_RESIZE

    def describe(self) -> str:
        return f"frontend fleet {self.current} → {self.target}"


@dataclass(frozen=True)
class PoolMove:
    """Move one engine between the prefill and decode pools live:
    drain under the old role, deregister, re-register under the new
    role (worker admin RPC → WorkerRoleManager.set_role)."""

    worker: str          # autoscaler registration key tail (lease hex)
    instance_id: int     # runtime instance id (== worker primary lease)
    src: str             # POOL_* constant
    dst: str

    kind = KIND_POOL_MOVE

    def describe(self) -> str:
        return f"worker {self.worker} {self.src} → {self.dst}"


@dataclass(frozen=True)
class ReplicaScale:
    """Scale a pool's replica count with zero-downtime handoff: a new
    replica registers (and is warm — registration happens after engine
    warm-up) BEFORE any victim drains."""

    pool: str            # POOL_* constant
    target: int
    current: int

    kind = KIND_REPLICA_SCALE

    def describe(self) -> str:
        return f"{self.pool} replicas {self.current} → {self.target}"


ScaleAction = FleetResize | PoolMove | ReplicaScale


@dataclass(frozen=True)
class Hold:
    """An explicit no-op decision with its reason — cold starts, empty
    metric windows, cooldowns, and out-of-profile operating points all
    clamp HERE, never to NaN or a negative pool size."""

    reason: str          # "empty_window" | "cooldown" | "hysteresis" | ...

    kind = "hold"

    def describe(self) -> str:
        return f"hold ({self.reason})"


def actions_prefix(operator_id: str) -> str:
    return f"planner/{operator_id}/actions/"


class ActionJournal:
    """Store-backed action ledger: one key per actuation attempt,
    written as INTENT before the actuator runs and rewritten with the
    outcome after. Keys are lease-attached to the operator's primary
    lease, so a crashed operator leaks nothing — the chaos suite pins
    `planner/` key emptiness after operator death."""

    def __init__(self, store, operator_id: str, lease_id: int, keep: int = 64):
        self.store = store
        self.operator_id = operator_id
        self.lease_id = lease_id
        self.keep = keep
        self._seq = 0

    def _key(self, seq: int) -> str:
        return f"{actions_prefix(self.operator_id)}{seq:08d}"

    async def record_intent(self, action: ScaleAction) -> int:
        self._seq += 1
        seq = self._seq
        entry = {"kind": action.kind, "phase": "started", **asdict(action)}
        await self.store.put(
            self._key(seq), json.dumps(entry).encode(), lease_id=self.lease_id
        )
        if seq > self.keep:
            # Bounded ledger: trim the oldest entry (best-effort; the
            # lease reaps everything at operator death anyway).
            try:
                await self.store.delete(self._key(seq - self.keep))
            except Exception:  # noqa: BLE001 — a failed trim only delays cleanup to lease expiry
                pass
        return seq

    async def record_outcome(self, seq: int, action: ScaleAction, outcome: str,
                             detail: str = "") -> None:
        entry = {
            "kind": action.kind, "phase": outcome, "detail": detail,
            **asdict(action),
        }
        await self.store.put(
            self._key(seq), json.dumps(entry).encode(), lease_id=self.lease_id
        )

    async def entries(self) -> list[dict]:
        out = []
        for e in sorted(
            await self.store.get_prefix(actions_prefix(self.operator_id)),
            key=lambda e: e.key,
        ):
            try:
                out.append(json.loads(e.value))
            except (ValueError, TypeError):
                continue
        return out
