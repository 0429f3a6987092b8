"""Discovery client: a live, watched view of an endpoint's instances.

Reference analogue: ``Client::new_dynamic`` with an etcd prefix watcher
feeding a ``tokio::sync::watch`` of instances, availability filtering, and
``report_instance_down`` (reference: lib/runtime/src/component/client.rs:
66-84,134-143,204-258).

Fault marking here is a per-instance *circuit breaker* rather than a
permanent local blacklist: ``report_instance_down`` opens the circuit
(instance excluded from routing), after ``circuit_cooldown`` seconds one
probe request is let through (half-open), and ``report_instance_up``
closes it again. Without the breaker a marked-down instance that never
re-registers (e.g. transient network partition, lease kept alive) would
be starved forever; with it, recovery is bounded by the cooldown.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from dynamo_tpu_torch.runtime.component import Instance, instance_prefix
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import EventKind, KeyValueStore

log = get_logger("client")


@dataclass
class _Breaker:
    """Per-instance circuit state. ``state`` is "open" (excluded) or
    "half-open" (one probe window granted); closed == no breaker entry."""

    state: str
    since: float  # monotonic instant of the last state transition


class DiscoveryClient:
    def __init__(
        self,
        store: KeyValueStore,
        namespace: str,
        component: str,
        endpoint: str,
        circuit_cooldown: float = 5.0,
        metrics=None,
    ):
        self.namespace = namespace
        self.component = component
        self.endpoint = endpoint
        self.circuit_cooldown = circuit_cooldown
        # Optional MetricsRegistry: per-instance breaker state as a gauge
        # (0 closed / 1 open / 2 half-open), labeled by subject + instance.
        self._m_breaker = (
            metrics.gauge(
                "circuit_breaker_state",
                "Per-instance circuit breaker (0=closed, 1=open, 2=half-open)",
            )
            if metrics is not None
            else None
        )
        self._store = store
        self._prefix = instance_prefix(namespace, component, endpoint)
        self._instances: dict[str, Instance] = {}
        self._breakers: dict[int, _Breaker] = {}
        self._changed = asyncio.Event()
        self._version = 0
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._started = False

    async def start(self) -> "DiscoveryClient":
        if self._started:
            return self
        self._started = True
        self._watch = await self._store.watch_prefix(self._prefix)
        for entry in self._watch.snapshot:
            self._instances[entry.key] = Instance.from_bytes(entry.value)
        self._notify_changed()
        self._watch_task = asyncio.get_running_loop().create_task(self._watch_loop())
        return self

    async def _watch_loop(self) -> None:
        try:
            async for ev in self._watch:
                if ev.kind == EventKind.PUT:
                    inst = Instance.from_bytes(ev.value)
                    self._instances[ev.key] = inst
                    # A re-registered instance id is alive again.
                    if self._breakers.pop(inst.instance_id, None) is not None:
                        self._set_breaker_gauge(inst.instance_id, "closed")
                else:
                    inst = self._instances.pop(ev.key, None)
                    if inst is not None:
                        self._breakers.pop(inst.instance_id, None)
                        self._set_breaker_gauge(inst.instance_id, None)
                self._notify_changed()
        except asyncio.CancelledError:
            pass

    def instances(self) -> list[Instance]:
        """All registered instances, including ones locally marked down."""
        return list(self._instances.values())

    def available(self) -> list[Instance]:
        """Instances routable right now: circuit closed, or open past the
        cooldown (transitions to half-open and admits probe traffic)."""
        now = time.monotonic()
        return [
            i for i in self._instances.values() if self._circuit_allows(i.instance_id, now)
        ]

    def _circuit_allows(self, instance_id: int, now: float) -> bool:
        b = self._breakers.get(instance_id)
        if b is None:
            return True
        if now - b.since >= self.circuit_cooldown:
            # open → half-open: grant one probe *window* per cooldown. The
            # probe's outcome resolves the state: report_instance_up closes
            # the circuit, report_instance_down re-opens it (timer reset).
            if b.state != "half-open":
                log.info("instance %x half-open: allowing probe", instance_id)
                self._set_breaker_gauge(instance_id, "half-open")
            b.state = "half-open"
            b.since = now
            return True
        return b.state == "half-open"

    _BREAKER_LEVELS = {"closed": 0.0, "open": 1.0, "half-open": 2.0}

    def _set_breaker_gauge(self, instance_id: int, state: str | None) -> None:
        if self._m_breaker is None:
            return
        labels = {
            "subject": f"{self.namespace}/{self.component}/{self.endpoint}",
            "instance": f"{instance_id:x}",
        }
        if state is None:  # instance gone: drop the series, not freeze it
            self._m_breaker.remove(**labels)
        else:
            self._m_breaker.set(self._BREAKER_LEVELS[state], **labels)

    def breaker_state(self, instance_id: int) -> str:
        """"closed" | "open" | "half-open" (observability/tests)."""
        b = self._breakers.get(instance_id)
        return "closed" if b is None else b.state

    def instance_ids(self) -> list[int]:
        return [i.instance_id for i in self.available()]

    def get(self, instance_id: int) -> Instance | None:
        for inst in self._instances.values():
            if inst.instance_id == instance_id:
                return inst
        return None

    def report_instance_down(self, instance_id: int) -> None:
        """Fast-path fault marking before the lease expires
        (reference: client.rs:134-143): opens the circuit. Cleared when the
        watch shows the instance re-register or vanish, when a half-open
        probe succeeds, or — failing all that — probed again every
        ``circuit_cooldown`` seconds."""
        self._breakers[instance_id] = _Breaker("open", time.monotonic())
        self._set_breaker_gauge(instance_id, "open")
        self._notify_changed()

    def report_instance_up(self, instance_id: int) -> None:
        """A request to this instance succeeded — close its circuit."""
        if self._breakers.pop(instance_id, None) is not None:
            log.info("instance %x back up: circuit closed", instance_id)
            self._set_breaker_gauge(instance_id, "closed")
            self._notify_changed()

    def _notify_changed(self) -> None:
        self._version += 1
        self._changed.set()

    @property
    def version(self) -> int:
        """Monotonic change counter. Read it before acting on the instance
        set, then pass it to wait_changed to avoid lost wakeups."""
        return self._version

    async def wait_changed(self, seen_version: int, timeout: float | None = None) -> int:
        """Block until the instance set has changed past ``seen_version``
        (returns immediately if it already has — no lost-wakeup window).
        Returns the current version."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        while self._version == seen_version:
            self._changed.clear()
            if self._version != seen_version:  # changed between check & clear
                break
            remaining = None if deadline is None else max(0.0, deadline - loop.time())
            if remaining == 0.0:
                break
            try:
                await asyncio.wait_for(self._changed.wait(), remaining)
            except asyncio.TimeoutError:
                break
        return self._version

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> list[Instance]:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            v = self._version  # read BEFORE the state check (no lost wakeup)
            if len(self.available()) >= n:
                return self.available()
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self._prefix}: {len(self.available())}/{n} instances after {timeout}s"
                )
            await self.wait_changed(v, remaining)

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
        if self._watch is not None:
            await self._watch.cancel()
