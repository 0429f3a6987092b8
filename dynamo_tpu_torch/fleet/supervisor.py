"""Fleet supervisor: N frontend processes behaving as one frontend.

Launch via ``python -m dynamo_tpu_torch.frontend --fleet N`` (the frontend CLI
delegates here; ``python -m dynamo_tpu_torch.fleet`` is an alias). The
supervisor owns:

- **the shared port** — children bind the same (host, port) with
  ``SO_REUSEPORT`` so the kernel load-balances accepts across processes;
  on platforms without it the supervisor binds one listening socket and
  children inherit the fd (``--inherited-socket-fd``);
- **crash recovery** — a child that exits unexpectedly is restarted
  after a jittered exponential backoff (per-slot failure counter, reset
  once the child survives ``restart_reset_after`` seconds). Its leased
  admission-budget chunks return via store lease expiry, so the fleet's
  global inflight bound holds across the crash;
- **rolling drain** — SIGHUP drains and restarts one child at a time
  (SIGTERM → child sheds new work, finishes in-flight streams, returns
  its budget, flushes its decision-cache leases, exits) while siblings
  absorb traffic; SIGTERM/SIGINT forwards SIGTERM to every child and
  waits for the fleet to drain in parallel;
- **aggregation** — an admin endpoint merging per-child ``/metrics``
  (every sample relabeled ``fleet_worker_id``) and ``/debug/requests``,
  plus ``/health`` and ``/fleet`` fleet-status JSON.

Chaos: with ``DYNTPU_CHAOS_FRONTEND_KILL_P`` set the supervisor consults
the seeded injector once per monitor tick and SIGKILLs a (seeded-)random
child — the kill-a-frontend fault the chaos suite drives.

The admin site runs on the port's asyncio HTTP server
(``runtime/http_server.py``) and scrapes the children with the port's
client (``llm/client.py``): aiohttp is absent on the machines the port
targets. The aggregated ``/debug/requests`` also joins each record with
the phases its trace's store-exported spans carry from other processes
(a worker's ``engine.queue``/``engine.prefill``/``engine.decode``), which
a child frontend's own ledger cannot see.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

from dynamo_tpu_torch.fleet import FleetError, register_fleet_supervisor_metrics
from dynamo_tpu_torch.fleet.aggregate import merge_ledgers, merge_metrics, merge_traces
from dynamo_tpu_torch.fleet.backoff import BackoffPolicy
from dynamo_tpu_torch.fleet.budget import budget_prefix
from dynamo_tpu_torch.llm.client import OpenAIClient
from dynamo_tpu_torch.runtime import http_server as web
from dynamo_tpu_torch.runtime.config import Config
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.store import connect_store
from dynamo_tpu_torch.runtime.tracing import PHASE_SPANS

log = get_logger("fleet")

# Flags consumed by the supervisor itself and stripped from the child
# argv (children get per-child flags appended instead).
_SUPERVISOR_FLAGS = {"--fleet", "--fleet-admin-port", "--port"}


def frontends_prefix(fleet_id: str) -> str:
    return f"fleet/{fleet_id}/frontends/"


class _Slot:
    """One child slot: the process occupying it plus restart bookkeeping."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id
        self.proc: subprocess.Popen | None = None
        self.started_at = 0.0
        self.failures = 0
        self.restart_at = 0.0  # monotonic deadline; 0 = not pending
        self.draining = False  # expected exit (rolling drain/shutdown)
        self.restarts = 0


class FleetSupervisor:
    def __init__(
        self,
        n: int,
        child_argv: list[str],
        host: str,
        port: int,
        fleet_id: str,
        store_url: str,
        config: Config | None = None,
        admin_host: str = "127.0.0.1",
        admin_port: int = 0,
        chaos=None,
    ):
        if n < 1:
            raise FleetError("--fleet must be >= 1")
        if not store_url.startswith("tcp://"):
            raise FleetError(
                "fleet mode needs a shared tcp:// store (budget leases and "
                f"sticky routing live there); got {store_url!r}"
            )
        self.n = n
        self.child_argv = child_argv
        self.host = host
        self.port = port
        self.fleet_id = fleet_id
        self.store_url = store_url
        self.config = config or Config.from_env()
        self.admin_host = admin_host
        self.admin_port = admin_port
        self.chaos = chaos
        self.slots = [_Slot(i) for i in range(n)]
        self.backoff = BackoffPolicy(
            self.config.fleet.restart_backoff_base,
            self.config.fleet.restart_backoff_max,
            self.config.fleet.restart_reset_after,
        )
        self.metrics = MetricsRegistry()
        self._m = register_fleet_supervisor_metrics(self.metrics)
        if self.chaos is not None:
            # chaos_injections_total{kind="frontend_kill"} rides the
            # supervisor's registry into the aggregated /metrics.
            self.chaos.bind_metrics(self.metrics)
        self._sock: socket.socket | None = None
        self._inherit_fd: int | None = None
        self._store = None
        self._runner: web.AppRunner | None = None
        self._stop = asyncio.Event()
        self._rolling: asyncio.Task | None = None
        # Serializes resize/rolling-drain admin RPCs: one structural
        # change to the slot list at a time.
        self._resize_lock = asyncio.Lock()

    # -- shared listen socket ---------------------------------------------

    def _bind_shared_socket(self) -> None:
        """Resolve the fleet port and pick the sharing strategy.

        SO_REUSEPORT path: the supervisor binds a *reservation* socket
        (bound, never listening — it reserves the port against other
        processes and resolves port 0) and each child binds its own
        listening socket with SO_REUSEPORT; the kernel spreads accepts.
        Fallback: the supervisor binds + listens once and children
        inherit the fd.
        """
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        reuseport = hasattr(socket, "SO_REUSEPORT")
        if reuseport:
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except OSError:
                reuseport = False
        sock.bind((self.host, self.port))
        self.port = sock.getsockname()[1]
        if not reuseport:
            sock.listen(1024)
            sock.set_inheritable(True)
            self._inherit_fd = sock.fileno()
        self._sock = sock

    def _spawn_args(self, worker_id: int) -> tuple[list[str], dict, list[int]]:
        argv = [sys.executable, "-m", "dynamo_tpu_torch.frontend", *self.child_argv]
        argv += ["--port", str(self.port), "--fleet-worker-id", str(worker_id)]
        pass_fds: list[int] = []
        if self._inherit_fd is not None:
            argv += ["--inherited-socket-fd", str(self._inherit_fd)]
            pass_fds.append(self._inherit_fd)
        else:
            argv += ["--reuse-port"]
        env = dict(os.environ)
        return argv, env, pass_fds

    def _spawn_proc(self, worker_id: int) -> subprocess.Popen:
        argv, env, pass_fds = self._spawn_args(worker_id)
        return subprocess.Popen(argv, env=env, pass_fds=pass_fds)

    async def _spawn(self, slot: _Slot) -> None:
        def spawn_and_track() -> None:
            # slot.proc is assigned ON the executor thread: if the
            # awaiting task is cancelled mid-Popen (fleet shutdown racing
            # a backoff restart), the already-created child is still
            # tracked and shutdown()'s terminate/kill loop reaps it
            # instead of leaking an orphan on the shared port.
            slot.proc = self._spawn_proc(slot.worker_id)

        await asyncio.to_thread(spawn_and_track)
        slot.started_at = time.monotonic()
        slot.restart_at = 0.0
        slot.draining = False
        log.info("fleet worker %d spawned (pid %d)", slot.worker_id, slot.proc.pid)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "FleetSupervisor":
        init_logging()
        self._bind_shared_socket()
        self._store = await connect_store(self.store_url)
        for slot in self.slots:
            await self._spawn(slot)
        await self._start_admin()
        return self

    async def _start_admin(self) -> None:
        app = web.Application()
        app.router.add_get("/metrics", self._agg_metrics)
        app.router.add_get("/debug/requests", self._agg_requests)
        app.router.add_get("/debug/fleet/traces/{trace_id}", self._fleet_trace)
        app.router.add_get("/health", self._agg_health)
        app.router.add_get("/fleet", self._fleet_status)
        app.router.add_post("/fleet/resize", self._fleet_resize)
        app.router.add_post("/fleet/roll", self._fleet_roll)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.admin_host, self.admin_port)
        await site.start()
        self.admin_port = site._server.sockets[0].getsockname()[1]

    async def registrations(self) -> dict[int, dict]:
        """Live child registrations from the store (lease-backed, so a
        dead child's entry is already gone)."""
        out: dict[int, dict] = {}
        for entry in await self._store.get_prefix(frontends_prefix(self.fleet_id)):
            try:
                wid = int(entry.key.rsplit("/", 1)[1])
                out[wid] = json.loads(entry.value)
            except (ValueError, IndexError):
                continue
        return out

    async def wait_ready(self, timeout: float = 60.0) -> bool:
        """→ True once every slot's CURRENT pid has registered. Returns
        early (False) on shutdown so a signal during a crash-looping
        start is honored immediately, not after the timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            regs = await self.registrations()
            pids = {s.worker_id: s.proc.pid for s in self.slots if s.proc is not None}
            if all(
                wid in regs and regs[wid].get("pid") == pid for wid, pid in pids.items()
            ) and len(pids) == self.n:
                return True
            await asyncio.sleep(0.1)
        return False

    def alive(self) -> list[_Slot]:
        return [s for s in self.slots if s.proc is not None and s.proc.poll() is None]

    async def monitor(self) -> None:
        """Crash detection + backoff restarts + seeded chaos kills."""
        interval = self.config.fleet.monitor_interval
        while not self._stop.is_set():
            try:
                self._monitor_tick(time.monotonic())
                await self._restart_due(time.monotonic())
            except Exception:  # noqa: BLE001 — the monitor must outlive a failed tick (e.g. Popen EAGAIN under memory pressure, exactly when children crash); the next tick retries
                log.exception("fleet monitor tick failed; retrying")
            self._m["workers_alive"].set(len(self.alive()))
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._stop.wait(), interval)

    def _monitor_tick(self, now: float) -> None:
        if self.chaos is not None:
            victim = self.chaos.maybe_kill_frontend(self.alive())
            if victim is not None:
                log.warning("chaos: SIGKILL fleet worker %d", victim.worker_id)
                victim.proc.kill()
        for slot in self.slots:
            if (
                slot.proc is not None and slot.proc.poll() is not None
                and not slot.draining and slot.restart_at == 0.0
            ):
                uptime = now - slot.started_at
                if uptime > self.backoff.reset_after:
                    slot.failures = 0
                slot.failures += 1
                delay = self.backoff.delay(slot.failures)
                slot.restart_at = now + delay
                log.warning(
                    "fleet worker %d exited rc=%s (uptime %.1fs): restart in %.2fs",
                    slot.worker_id, slot.proc.returncode, uptime, delay,
                )

    async def _restart_due(self, now: float) -> None:
        for slot in self.slots:
            if (
                slot.proc is not None and slot.proc.poll() is not None
                and not slot.draining
                and slot.restart_at != 0.0 and now >= slot.restart_at
            ):
                slot.restarts += 1
                self._m["restarts"].inc(worker=str(slot.worker_id))
                await self._spawn(slot)

    async def _wait_exit(self, slot: _Slot, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if slot.proc is None or slot.proc.poll() is not None:
                return True
            await asyncio.sleep(0.05)
        return False

    async def rolling_restart(self) -> None:
        """Drain one child at a time while its siblings absorb traffic:
        SIGTERM → the child stops admitting, finishes in-flight streams,
        releases budget + decision leases, exits → respawn → wait until
        the replacement registers → next child."""
        async with self._resize_lock:
            await self._rolling_restart_locked()

    async def _rolling_restart_locked(self) -> None:
        grace = self.config.runtime.graceful_shutdown_timeout + 10.0
        for slot in list(self.slots):
            if self._stop.is_set():
                return
            if slot.proc is None or slot.proc.poll() is not None:
                continue
            log.info("rolling drain: fleet worker %d (pid %d)", slot.worker_id, slot.proc.pid)
            slot.draining = True
            slot.proc.terminate()
            if not await self._wait_exit(slot, grace):
                log.warning("rolling drain: worker %d ignored SIGTERM, killing", slot.worker_id)
                slot.proc.kill()
                await self._wait_exit(slot, 5.0)
            try:
                await self._spawn(slot)
            except Exception:  # noqa: BLE001 — a failed respawn must not strand the slot: hand it to the monitor's backoff machinery and keep rolling
                log.exception(
                    "rolling drain: respawn of worker %d failed; monitor will retry",
                    slot.worker_id,
                )
                slot.draining = False  # exited + not draining ⇒ monitor restarts it
                continue
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline:
                regs = await self.registrations()
                if regs.get(slot.worker_id, {}).get("pid") == slot.proc.pid:
                    break
                await asyncio.sleep(0.1)
        log.info("rolling drain complete")

    async def resize(self, n: int) -> dict:
        """Resize the fleet at runtime (admin RPC — the autoscaler's
        frontend actuation). Growing spawns fresh slots and waits for
        their registration; shrinking retires the HIGHEST-id slots one
        at a time through the same zero-failure drain a rolling restart
        uses (SIGTERM → child leaves the accept group, drains streams,
        returns budget + decision leases, exits) — siblings absorb
        traffic throughout, so no stream fails."""
        if n < 1:
            raise FleetError("fleet size must be >= 1")
        async with self._resize_lock:
            grace = self.config.runtime.graceful_shutdown_timeout + 10.0
            grew = shrank = 0
            while len(self.slots) < n:
                slot = _Slot(max((s.worker_id for s in self.slots), default=-1) + 1)
                self.slots.append(slot)
                self.n = len(self.slots)
                try:
                    await self._spawn(slot)
                except Exception as e:  # noqa: BLE001 — a failed Popen (EAGAIN under pressure) must not leave a proc-less zombie slot the monitor can never restart
                    self.slots.pop()
                    self.n = len(self.slots)
                    raise FleetError(
                        f"resize: spawn of worker {slot.worker_id} failed: {e}"
                    ) from e
                grew += 1
            if grew:
                deadline = time.monotonic() + grace
                while time.monotonic() < deadline and not self._stop.is_set():
                    regs = await self.registrations()
                    if all(
                        s.worker_id in regs
                        for s in self.slots if s.proc is not None
                    ):
                        break
                    await asyncio.sleep(0.1)
            while len(self.slots) > n:
                slot = self.slots[-1]
                slot.draining = True
                if slot.proc is not None and slot.proc.poll() is None:
                    log.info(
                        "resize: draining fleet worker %d (pid %d)",
                        slot.worker_id, slot.proc.pid,
                    )
                    slot.proc.terminate()
                    if not await self._wait_exit(slot, grace):
                        log.warning(
                            "resize: worker %d ignored SIGTERM, killing",
                            slot.worker_id,
                        )
                        slot.proc.kill()
                        await self._wait_exit(slot, 5.0)
                self.slots.pop()
                self.n = len(self.slots)
                shrank += 1
            self._m["workers_alive"].set(len(self.alive()))
            log.info("fleet resized to %d (+%d/-%d)", self.n, grew, shrank)
            return {"fleet_size": self.n, "grew": grew, "shrank": shrank}

    async def shutdown(self) -> None:
        """Fleet-wide graceful stop: SIGTERM every child (each drains its
        own streams concurrently), escalate to SIGKILL on timeout."""
        self._stop.set()
        if self._rolling is not None:
            self._rolling.cancel()
        for slot in self.slots:
            slot.draining = True
            if slot.proc is not None and slot.proc.poll() is None:
                slot.proc.terminate()
        grace = self.config.runtime.graceful_shutdown_timeout + 10.0
        results = await asyncio.gather(
            *(self._wait_exit(s, grace) for s in self.slots)
        )
        for slot, clean in zip(self.slots, results):
            if not clean and slot.proc is not None:
                slot.proc.kill()
        if self._runner is not None:
            await self._runner.cleanup()
        if self._store is not None:
            await self._store.close()
        if self._sock is not None:
            self._sock.close()

    # -- aggregation endpoints --------------------------------------------

    async def _scrape(self, path: str) -> list[tuple[str, object]]:
        regs = await self.registrations()

        async def one(wid: int, reg: dict):
            try:
                async with OpenAIClient(reg.get("admin", ""), timeout=5.0) as client:
                    resp = await asyncio.wait_for(client.get(path), 5.0)
                if path == "/metrics":
                    return str(wid), resp.text
                return str(wid), resp.json()
            except Exception as e:  # noqa: BLE001 — a restarting child must not fail the whole fleet scrape
                self._m["scrape_errors"].inc()
                log.warning("scrape %s of worker %d failed: %s", path, wid, e)
                return None

        results = await asyncio.gather(*(one(w, r) for w, r in sorted(regs.items())))
        return [r for r in results if r is not None]

    async def _agg_metrics(self, request: web.Request) -> web.Response:
        parts = await self._scrape("/metrics")
        parts.append(("supervisor", self.metrics.render()))
        return web.Response(text=merge_metrics(parts), content_type="text/plain")

    async def _agg_requests(self, request: web.Request) -> web.Response:
        parts = await self._scrape("/debug/requests")
        body = merge_ledgers(parts)
        for rec in body["requests"]:
            await self._join_exported_phases(rec)
        return web.json_response(body)

    async def _join_exported_phases(self, rec: dict) -> None:
        """Add to one ledger record the phases that its trace's
        store-exported spans carry and its own phases lack: the frontend
        child that built the record recorded only its own spans, and a
        worker process's engine phases reach the fleet through the export
        alone. Every such span of the trace counts, so requests that share
        one client trace id share these sums."""
        from dynamo_tpu_torch.runtime.trace_export import load_fleet_trace

        trace_id = rec.get("trace_id")
        phases = rec.get("phases")
        if not trace_id or not isinstance(phases, dict):
            return
        extra: dict[str, float] = {}
        seen: set[str] = set()
        for d in await load_fleet_trace(self._store, self.fleet_id, trace_id):
            phase = PHASE_SPANS.get(d.get("name"))
            sid = d.get("span_id") or ""
            if phase is None or phase in phases or not sid or sid in seen:
                continue
            seen.add(sid)
            extra[phase] = extra.get(phase, 0.0) + float(d.get("duration_s") or 0.0)
        if extra:
            phases.update({k: round(v, 6) for k, v in extra.items()})
            rec["phases"] = dict(sorted(phases.items()))

    async def _fleet_trace(self, request: web.Request) -> web.Response:
        """One trace's complete cross-process span tree: every child's
        ``/debug/traces/{id}`` fragment (pull path) plus the store-backed
        export under ``fleet/<id>/trace/…`` (push path), stitched into a
        single Chrome-trace body with one lane per process. Deterministic
        serialization (sorted spans, sorted keys): repeated GETs of the
        same fragment set are byte-identical."""
        from dynamo_tpu_torch.runtime.trace_export import load_fleet_trace

        trace_id = request.match_info["trace_id"]
        parts = [
            (wid, body)
            for wid, body in await self._scrape(f"/debug/traces/{trace_id}")
            if isinstance(body, dict) and "traceEvents" in body
        ]
        extra = await load_fleet_trace(self._store, self.fleet_id, trace_id)
        if not parts and not extra:
            return web.json_response(
                {"error": f"unknown trace {trace_id}"}, status=404
            )
        body = merge_traces(trace_id, parts, extra_spans=extra)
        return web.json_response(
            body, dumps=lambda b: json.dumps(b, sort_keys=True)
        )

    async def _agg_health(self, request: web.Request) -> web.Response:
        regs = await self.registrations()
        alive = len(self.alive())
        body = {
            "status": "ready" if alive == self.n and len(regs) == self.n else "degraded",
            "workers_alive": alive,
            "workers_registered": len(regs),
            "fleet_size": self.n,
        }
        return web.json_response(body, status=200 if body["status"] == "ready" else 503)

    async def _fleet_status(self, request: web.Request) -> web.Response:
        regs = await self.registrations()
        chunks = await self._store.get_prefix(budget_prefix(self.fleet_id))
        # Per-class chunk accounting: QoS pools nest one level deeper
        # (budget/<class>/<k>); legacy single-pool keys have a bare
        # numeric tail and count under "shared".
        per_class: dict[str, int] = {}
        plen = len(budget_prefix(self.fleet_id))
        for e in chunks:
            tail = e.key[plen:]
            cls = tail.split("/", 1)[0] if "/" in tail else "shared"
            per_class[cls] = per_class.get(cls, 0) + 1
        # Per-child admission-gate state (per-class queued/inflight,
        # load-scaled retry_after, shed counts by reason) off each
        # child's /debug/admission — the QoS half of fleet status.
        admission = {
            wid: data for wid, data in await self._scrape("/debug/admission")
        }
        # Fleet-balancer decision state, published per cycle by the
        # operator under planner/<id>/balancer (lease-attached — a dead
        # operator's block vanishes with its lease). Keyed by operator
        # id since several operators may run against one store.
        balancer: dict[str, dict] = {}
        for e in await self._store.get_prefix("planner/"):
            parts = e.key.split("/")
            if len(parts) == 3 and parts[2] == "balancer":
                try:
                    balancer[parts[1]] = json.loads(e.value)
                except (ValueError, UnicodeDecodeError):
                    continue
        body = {
            "fleet_id": self.fleet_id,
            "fleet_size": self.n,
            "port": self.port,
            "socket_mode": "inherit" if self._inherit_fd is not None else "reuseport",
            "budget_chunks_claimed": len(chunks),
            "budget_chunks_by_class": per_class,
            "admission": admission,
            "balancer": balancer,
            "workers": [
                {
                    "worker_id": s.worker_id,
                    "pid": s.proc.pid if s.proc is not None else None,
                    "alive": s.proc is not None and s.proc.poll() is None,
                    "restarts": s.restarts,
                    "registered": s.worker_id in regs,
                }
                for s in self.slots
            ],
        }
        return web.json_response(body)

    async def _fleet_resize(self, request: web.Request) -> web.Response:
        """``POST /fleet/resize {"n": N}`` — the autoscaler's (and any
        operator's) runtime alternative to editing --fleet and
        restarting. Completes when the fleet has converged."""
        try:
            body = await request.json()
            n = int(body["n"])
        except (ValueError, KeyError, TypeError):
            return web.json_response({"error": "body must be {\"n\": int}"}, status=400)
        try:
            result = await self.resize(n)
        except FleetError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(result)

    async def _fleet_roll(self, request: web.Request) -> web.Response:
        """``POST /fleet/roll`` — trigger the rolling zero-failure drain
        via RPC instead of SIGHUP only (remote operators have HTTP, not
        signals). Returns immediately; /fleet shows progress."""
        if self._rolling is None or self._rolling.done():
            self._rolling = asyncio.get_running_loop().create_task(
                self.rolling_restart()
            )
            return web.json_response({"rolling": True})
        return web.json_response({"rolling": True, "already": True})

    # -- entry -------------------------------------------------------------

    async def run(self) -> None:
        await self.start()
        loop = asyncio.get_running_loop()
        print(
            f"dynamo_tpu fleet: http://{self.host}:{self.port} "
            f"admin http://{self.admin_host}:{self.admin_port} "
            f"({self.n} workers, {'inherited-listener' if self._inherit_fd is not None else 'SO_REUSEPORT'})",
            flush=True,
        )

        def on_stop() -> None:
            if self._stop.is_set():
                log.warning("second signal during fleet drain: forcing exit")
                for slot in self.slots:
                    if slot.proc is not None and slot.proc.poll() is None:
                        slot.proc.kill()
                os._exit(130)
            self._stop.set()

        def on_hup() -> None:
            if self._rolling is None or self._rolling.done():
                self._rolling = loop.create_task(self.rolling_restart())

        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, on_stop)
        with contextlib.suppress(NotImplementedError, AttributeError):
            loop.add_signal_handler(signal.SIGHUP, on_hup)

        monitor = loop.create_task(self.monitor())
        if await self.wait_ready():
            print(f"dynamo_tpu fleet ready ({self.n} workers)", flush=True)
        else:
            log.warning("fleet start: not all workers registered in time")
        await self._stop.wait()
        log.info("fleet shutting down (%d workers)", len(self.alive()))
        monitor.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await monitor
        await self.shutdown()


def strip_supervisor_flags(argv: list[str]) -> list[str]:
    """Remove supervisor-level flags (and --port, which the supervisor
    re-issues resolved) from the original CLI argv → child argv."""
    out: list[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        flag = a.split("=", 1)[0]
        if flag in _SUPERVISOR_FLAGS:
            skip = "=" not in a
            continue
        out.append(a)
    return out


def run_fleet(args, argv: list[str]) -> int:
    """Entry from ``python -m dynamo_tpu_torch.frontend --fleet N``."""
    from dynamo_tpu_torch.runtime.chaos import ChaosInjector

    config = Config.from_env()
    store_url = args.store_url or config.store.url
    sup = FleetSupervisor(
        n=args.fleet,
        child_argv=strip_supervisor_flags(argv),
        host=args.host,
        port=args.port,
        fleet_id=args.fleet_id,
        store_url=store_url,
        config=config,
        admin_port=args.fleet_admin_port,
        chaos=ChaosInjector.from_config(config.chaos),
    )
    asyncio.run(sup.run())
    return 0
