"""Actuators: how autoscaler actions reach the live fleet.

Three seams, one per action kind:

- **pool actuator** — moves engines between the prefill and decode
  pools and scales replica counts. The runtime implementation reads
  the lease-backed worker registrations (``autoscaler/<ns>/workers/``,
  written by :class:`~dynamo_tpu_torch.worker.roles.WorkerRoleManager`) and
  commands individual workers over the ``workerctl/admin`` endpoint
  with DIRECT instance routing — the same wire machinery every other
  RPC rides, so chaos (dead worker, cut store) surfaces as the typed
  errors the loop already survives.
- **replica launcher** — how new worker processes come to exist; a
  protocol so tests/benches launch in-process workers while production
  spawns ``python -m dynamo_tpu_torch.worker`` subprocesses.
- **fleet actuator** — the frontend supervisor's admin HTTP surface
  (``POST /fleet/resize``).

Zero-downtime invariants (docs/autoscaler.md "actuation matrix"):
scale-UP waits for the new replica's registration (registration
happens after engine warm-up) before returning; scale-DOWN retires the
newest worker via its admin RPC, which drains in-flight streams before
deregistering; a pool MOVE is the worker's own drain → deregister →
re-register transition, so the router never sees a half-moved worker.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass

from dynamo_tpu_torch.planner.actions import (
    POOL_DECODE,
    POOL_PREFILL,
    PoolMove,
    ReplicaScale,
    ScaleActionError,
)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.actuate")


def workers_prefix(namespace: str) -> str:
    return f"autoscaler/{namespace}/workers/"


def worker_key(namespace: str, lease_id: int) -> str:
    return f"{workers_prefix(namespace)}{lease_id:x}"


@dataclass(frozen=True)
class WorkerInfo:
    """One autoscalable worker as registered in the store."""

    key: str             # store key tail (lease hex)
    instance_id: int     # runtime instance id == the worker's primary lease
    role: str            # POOL_* constant
    pid: int = 0
    model: str = ""

    @classmethod
    def from_entry(cls, key: str, value: bytes) -> "WorkerInfo | None":
        try:
            d = json.loads(value)
            return cls(
                key=key.rsplit("/", 1)[1],
                instance_id=int(d["instance_id"]),
                role=d.get("role", POOL_DECODE),
                pid=int(d.get("pid") or 0),
                model=d.get("model", ""),
            )
        except (ValueError, KeyError, IndexError, TypeError):
            return None


async def read_pools(store, namespace: str) -> dict[str, list[WorkerInfo]]:
    """Live pool membership from the lease-backed registrations — a
    dead worker's entry is already gone, so this is the ground truth
    the level-based loop converges against."""
    pools: dict[str, list[WorkerInfo]] = {POOL_PREFILL: [], POOL_DECODE: []}
    for e in await store.get_prefix(workers_prefix(namespace)):
        info = WorkerInfo.from_entry(e.key, e.value)
        if info is not None and info.role in pools:
            pools[info.role].append(info)
    for lst in pools.values():
        lst.sort(key=lambda w: w.instance_id)
    return pools


class RuntimeActuator:
    """Pool actuation over the live runtime: store registrations for
    state, worker admin RPC for transitions, a ReplicaLauncher for
    process lifecycle. ``admin_router`` is a DIRECT-mode PushRouter on
    the ``workerctl/admin`` endpoint."""

    def __init__(self, store, namespace: str, admin_router,
                 launcher=None, converge_timeout_s: float = 120.0,
                 heat_source=None):
        self.store = store
        self.namespace = namespace
        self.admin_router = admin_router
        self.launcher = launcher
        self.converge_timeout_s = converge_timeout_s
        # Cache-aware victim choice: a fleet/directory.py PrefixDirectory
        # (or anything with .heat(instance_id) → float). None keeps the
        # age heuristic.
        self.heat_source = heat_source

    async def pools(self) -> dict[str, list[WorkerInfo]]:
        return await read_pools(self.store, self.namespace)

    async def _rpc(self, instance_id: int, payload: dict, attempts: int = 20) -> dict:
        """One admin command; → the worker's final reply frame. Retried
        briefly: a just-launched worker's store registration can land a
        beat before the DIRECT router's discovery watch mirrors its
        instance. Still failing → ScaleActionError — the caller records
        it and the loop re-plans from live state. (Admin commands are
        idempotent: set_role to the current role and retire-again are
        both no-ops.)"""
        from dynamo_tpu_torch.runtime import tracing
        from dynamo_tpu_torch.runtime.engine import Context

        # Planner action span: one root per actuation verb, its trace
        # threaded through the admin RPC so the worker-side effects
        # (role change, migrate_out fan-out) stitch under it in the
        # fleet-assembled timeline.
        span = tracing.start_span(
            "planner.action",
            cmd=str(payload.get("cmd")), instance=f"{instance_id:x}",
        )
        trace = span.trace_context() if span.recording else None
        try:
            last_err: Exception | None = None
            for i in range(attempts):
                last: dict = {}
                try:
                    async for frame in self.admin_router.generate(
                        dict(payload), Context(trace=trace), instance_id=instance_id
                    ):
                        if isinstance(frame, dict):
                            last = frame
                except Exception as e:  # noqa: BLE001 — transport-level failure: retry the idempotent command, typed error after the budget
                    last_err = e
                    await asyncio.sleep(0.1 * min(i + 1, 5))
                    continue
                if last.get("error"):
                    span.end(status="error")
                    raise ScaleActionError(
                        f"admin rpc {payload.get('cmd')} to {instance_id:x}: {last['error']}"
                    )
                span.set_attrs(attempts=i + 1)
                span.end()
                return last
            span.end(status="error")
            raise ScaleActionError(
                f"admin rpc {payload.get('cmd')} to {instance_id:x} failed: {last_err}"
            ) from last_err
        finally:
            span.end()

    def _pick(self, pools: dict, role: str) -> WorkerInfo:
        candidates = pools.get(role, [])
        if not candidates:
            raise ScaleActionError(f"no workers in pool {role!r}")
        return self._coldest(candidates)

    def _coldest(self, candidates: list[WorkerInfo]) -> WorkerInfo:
        """The candidate whose removal wastes the least warm cache.

        With a prefix directory wired, that is MEASURED: minimum
        exclusivity-weighted resident-prefix heat (a worker whose blocks
        are replicated on peers or spilled to G4 scores near zero even
        if it is old). Ties — and the no-directory case — fall back to
        newest-first, the age proxy for the same thing."""
        if self.heat_source is not None:
            try:
                heats = {
                    w.key: float(self.heat_source.heat(w.instance_id))
                    for w in candidates
                }
                coldest = min(heats.values())
                cold = [w for w in candidates if heats[w.key] == coldest]
                if len(cold) > 1 or coldest > 0.0:
                    log.info(
                        "victim heat: %s → picking %s",
                        {k: round(v, 2) for k, v in heats.items()},
                        cold[-1].key,
                    )
                return cold[-1]  # tie → newest
            except Exception as e:  # noqa: BLE001 — a degraded directory must not block scale-down; age heuristic still converges
                log.warning("heat source failed (%s); age heuristic", e)
        return candidates[-1]

    async def move(self, action: PoolMove) -> None:
        pools = await self.pools()
        if action.worker:
            info = next(
                (w for w in pools.get(action.src, []) if w.key == action.worker), None
            )
            if info is None:
                raise ScaleActionError(
                    f"worker {action.worker} not in pool {action.src!r}"
                )
        else:
            info = self._pick(pools, action.src)
        # Relocate-not-drain: the worker live-migrates its running
        # decodes to pool peers before the drain; any sequence that
        # fails to relocate falls back to the drain as before.
        await self._rpc(
            info.instance_id,
            {"cmd": "set_role", "role": action.dst, "relocate": True},
        )
        await self._wait(
            lambda pools: any(
                w.key == info.key for w in pools.get(action.dst, ())
            ),
            f"worker {info.key} to re-register as {action.dst}",
        )

    async def scale(self, action: ReplicaScale) -> None:
        pools = await self.pools()
        current = len(pools.get(action.pool, ()))
        if action.target > current:
            if self.launcher is None:
                # Scale-DOWN needs only the retire RPC; UP needs a way
                # to bring processes into existence.
                raise ScaleActionError("no replica launcher wired")
            for _ in range(action.target - current):
                await self.launcher.launch(action.pool)
            # Zero-downtime contract: the action completes only once the
            # new replicas are REGISTERED (registration follows engine
            # warm-up), so a paired retirement can never run early.
            await self._wait(
                lambda pools: len(pools.get(action.pool, ())) >= action.target,
                f"{action.pool} pool to reach {action.target}",
            )
        elif action.target < current:
            # The retire RPC acks BEFORE the worker's registration key
            # vanishes (drain runs in the background), so a multi-step
            # shrink must exclude already-retired victims or it would
            # re-pick the same still-registered worker every iteration.
            retired: set[str] = set()
            for _ in range(current - action.target):
                pools = await self.pools()
                candidates = [
                    w for w in pools.get(action.pool, ()) if w.key not in retired
                ]
                if not candidates or len(pools.get(action.pool, ())) <= action.target:
                    break
                victim = self._coldest(candidates)
                await self._retire(victim)
                retired.add(victim.key)
            await self._wait(
                lambda pools: len(pools.get(action.pool, ())) <= action.target,
                f"{action.pool} pool to drain to {action.target}",
            )

    async def _retire(self, victim: WorkerInfo) -> None:
        try:
            # Retirement relocates running decodes to the surviving pool
            # first (drain remains the per-sequence fallback).
            await self._rpc(victim.instance_id, {"cmd": "retire", "relocate": True})
        except ScaleActionError:
            # A worker that died mid-drain (or whose stream was cut by
            # its own exit) converges the same way: its lease-backed
            # registration vanishes; fall through to the launcher's
            # process-level teardown if one is wired.
            log.warning("retire rpc to %s failed; relying on process teardown", victim.key)
        if self.launcher is not None and hasattr(self.launcher, "retire"):
            await self.launcher.retire(victim)

    async def _wait(self, cond, what: str) -> None:
        deadline = time.monotonic() + self.converge_timeout_s
        while time.monotonic() < deadline:
            if cond(await self.pools()):
                return
            await asyncio.sleep(0.1)
        raise ScaleActionError(f"timed out waiting for {what}")


class ProcessReplicaLauncher:
    """Spawns worker replicas as local subprocesses (the production
    single-host story; the K8s path scales Deployments through the
    existing connector instead). ``base_argv[pool]`` is the worker CLI
    argv after the interpreter."""

    def __init__(self, base_argv: dict[str, list[str]]):
        self.base_argv = base_argv
        self.procs: list = []

    async def launch(self, pool: str) -> None:
        import subprocess
        import sys

        argv = [sys.executable, "-m", "dynamo_tpu_torch.worker", *self.base_argv[pool]]
        proc = await asyncio.to_thread(subprocess.Popen, argv)
        self.procs.append(proc)
        log.info("launched %s replica pid %d", pool, proc.pid)

    async def retire(self, victim: WorkerInfo) -> None:
        import signal

        for p in self.procs:
            if p.pid == victim.pid and p.poll() is None:
                p.send_signal(signal.SIGTERM)

    async def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                await asyncio.to_thread(p.wait, 10)
            except Exception:  # noqa: BLE001 — escalate: a worker ignoring SIGTERM at teardown gets SIGKILL
                p.kill()


class FleetHttpActuator:
    """Frontend-fleet actuation over the supervisor's admin endpoint:
    ``GET /fleet`` for the live child count, ``POST /fleet/resize`` to
    grow/shrink through the rolling zero-failure drain. Plain HTTP/1.1
    through the standard library (httpx is absent on the card's machine),
    one request per call on a worker thread."""

    def __init__(self, admin_url: str, timeout_s: float = 120.0):
        self.admin_url = admin_url.rstrip("/")
        self.timeout_s = timeout_s

    @staticmethod
    def _request(method: str, url: str, body: dict | None, timeout: float) -> dict:
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:  # raises on 4xx/5xx
            raw = r.read()
        return json.loads(raw) if raw else {}

    async def fleet_size(self) -> int:
        d = await asyncio.to_thread(self._request, "GET", f"{self.admin_url}/fleet", None, 10.0)
        return int(d.get("fleet_size", 0))

    async def resize_fleet(self, n: int) -> None:
        try:
            await asyncio.to_thread(self._request, "POST", f"{self.admin_url}/fleet/resize",
                                    {"n": int(n)}, self.timeout_s)
        except Exception as e:
            raise ScaleActionError(f"fleet resize to {n} failed: {e}") from e


class RecordingActuator:
    """Test double implementing both actuator protocols: applies
    actions to an in-memory pool map and records every call."""

    def __init__(self, prefill: int = 1, decode: int = 1, fleet: int = 1):
        self._pools = {
            POOL_PREFILL: [
                WorkerInfo(key=f"p{i}", instance_id=i, role=POOL_PREFILL)
                for i in range(prefill)
            ],
            POOL_DECODE: [
                WorkerInfo(key=f"d{i}", instance_id=100 + i, role=POOL_DECODE)
                for i in range(decode)
            ],
        }
        self.fleet = fleet
        self.calls: list = []
        self.fail_next: Exception | None = None
        self._seq = 1000

    def _maybe_fail(self) -> None:
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc

    async def pools(self):
        return {k: list(v) for k, v in self._pools.items()}

    async def move(self, action: PoolMove) -> None:
        self.calls.append(("move", action.src, action.dst))
        self._maybe_fail()
        src = self._pools[action.src]
        if not src:
            raise ScaleActionError(f"no workers in pool {action.src!r}")
        w = src.pop()
        self._pools[action.dst].append(
            WorkerInfo(key=w.key, instance_id=w.instance_id, role=action.dst)
        )

    async def scale(self, action: ReplicaScale) -> None:
        self.calls.append(("scale", action.pool, action.target))
        self._maybe_fail()
        pool = self._pools[action.pool]
        while len(pool) < action.target:
            self._seq += 1
            pool.append(WorkerInfo(
                key=f"n{self._seq}", instance_id=self._seq, role=action.pool
            ))
        while len(pool) > action.target:
            pool.pop()

    async def fleet_size(self) -> int:
        return self.fleet

    async def resize_fleet(self, n: int) -> None:
        self.calls.append(("fleet", n))
        self._maybe_fail()
        self.fleet = n
