"""DistributedRuntime: the per-process cluster handle.

Reference analogue: ``DistributedRuntime::from_settings`` — store client,
primary lease with keepalive, lazy ingress server, component registry,
metrics registry, system health (reference: lib/runtime/src/distributed.rs:
46-163, lib.rs:82-148).
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any

from dynamo_tpu_torch.runtime.client import DiscoveryClient
from dynamo_tpu_torch.runtime.component import (
    Instance,
    endpoint_subject,
    instance_key,
    validate_name,
)
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.config import Config
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging
from dynamo_tpu_torch.runtime.messaging import EndpointServer, Handler, MessageClient
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.store import KeyValueStore, connect_store

log = get_logger("distributed")


class SystemHealth:
    """Tracks process liveness/readiness for the system status server
    (reference: lib/runtime/src/lib.rs:82-148)."""

    def __init__(self) -> None:
        self.live = True
        self.endpoint_health: dict[str, bool] = {}

    def set_endpoint_health(self, subject: str, healthy: bool) -> None:
        self.endpoint_health[subject] = healthy

    @property
    def ready(self) -> bool:
        return self.live and all(self.endpoint_health.values())


class ServeHandle:
    """Returned by Endpoint.serve; closes cleanly: deregister → drain."""

    def __init__(
        self,
        runtime: "DistributedRuntime",
        inst: Instance,
        key: str,
        drain_timeout: float | None = None,
    ):
        self.runtime = runtime
        self.instance = inst
        self.key = key
        self.drain_timeout = drain_timeout
        self._closed = False

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with contextlib.suppress(Exception):
            await self.runtime.store.delete(self.key)
        server = self.runtime._server
        if server is not None:
            timeout = (
                self.drain_timeout
                if self.drain_timeout is not None
                else self.runtime.config.runtime.graceful_shutdown_timeout
            )
            await server.drain(self.instance.subject, timeout)
        self.runtime.health.endpoint_health.pop(self.instance.subject, None)


class Endpoint:
    def __init__(self, component: "Component", name: str):
        self.component = component
        self.name = validate_name(name, "endpoint")

    @property
    def namespace(self) -> str:
        return self.component.namespace.name

    @property
    def subject(self) -> str:
        return endpoint_subject(self.namespace, self.component.name, self.name)

    async def serve(self, handler: Handler, drain_timeout: float | None = None) -> ServeHandle:
        """Register a streaming handler and advertise a live instance.

        The handler has the AsyncEngine shape: (payload, Context) → async
        iterator of msgpack-able payloads.

        ``drain_timeout`` overrides the graceful-shutdown wait for this
        endpoint; 0 cancels in-flight streams immediately — required for
        endpoints serving never-ending infrastructure streams (KV event
        subscriptions)."""
        return await self.component.namespace.runtime._serve(self, handler, drain_timeout)

    async def serve_engine(self, engine: AsyncEngine) -> ServeHandle:
        async def handler(payload: Any, ctx: Context):
            async for item in engine.generate(payload, ctx):
                yield item

        return await self.serve(handler)

    async def client(self) -> DiscoveryClient:
        rt = self.component.namespace.runtime
        return await rt._discovery(self.namespace, self.component.name, self.name)

    async def router(self, mode: RouterMode = RouterMode.ROUND_ROBIN) -> PushRouter:
        rt = self.component.namespace.runtime
        discovery = await self.client()
        rcfg = rt.config.runtime
        return PushRouter(
            discovery,
            rt.messaging,
            mode,
            backoff_base=rcfg.retry_backoff_base,
            backoff_max=rcfg.retry_backoff_max,
            metrics=rt.metrics,
        )


class Component:
    def __init__(self, namespace: "Namespace", name: str):
        self.namespace = namespace
        self.name = validate_name(name, "component")

    def endpoint(self, name: str) -> Endpoint:
        return Endpoint(self, name)


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str):
        self.runtime = runtime
        self.name = validate_name(name, "namespace")

    def component(self, name: str) -> Component:
        return Component(self, name)


class DistributedRuntime:
    """One per process. Owns: store client + primary lease, the endpoint
    server (lazy), the message client, discovery clients, metrics."""

    def __init__(
        self,
        store: KeyValueStore,
        config: Config,
        advertise_host: str | None = None,
        proc_label: str | None = None,
    ):
        init_logging()
        self.store = store
        self.config = config
        # Trace-lane identity: which process/role lane this runtime's
        # handler-side spans land in (defaults to the process lane; the
        # endpoint server narrows it per request so in-process fleets
        # render distinct lanes per runtime).
        self.proc_label = proc_label or tracing.default_lane()
        self.metrics = MetricsRegistry()
        # Span durations land in this registry as phase histograms (the
        # recorder is process-global; the sink is removed on shutdown so
        # short-lived runtimes don't accumulate).
        self._tracing_sink = tracing.install_metrics_sink(self.metrics)
        self.health = SystemHealth()
        self.messaging = MessageClient(config.store.connect_timeout)
        self._advertise_host = advertise_host
        self._server: EndpointServer | None = None
        self._lease_id: int | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._discoveries: dict[tuple[str, str, str], DiscoveryClient] = {}
        self._handles: list[ServeHandle] = []
        self._shutdown = asyncio.Event()
        self._system_server = None

    @classmethod
    async def create(
        cls,
        store_url: str | None = None,
        config: Config | None = None,
        advertise_host: str | None = None,
        proc_label: str | None = None,
    ) -> "DistributedRuntime":
        config = config or Config.from_env()
        store = await connect_store(store_url or config.store.url, config.store.lease_ttl)
        rt = cls(store, config, advertise_host, proc_label)
        if config.system.enabled:
            # Per-process /health /live /metrics (reference: every process
            # runs the system server, http_server.rs:33-69).
            from dynamo_tpu_torch.runtime.http_server import SystemHttpServer

            rt._system_server = await SystemHttpServer(
                rt, config.system.host, config.system.port
            ).start()
        return rt

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    async def primary_lease(self) -> int:
        if self._lease_id is None:
            ttl = self.config.store.lease_ttl
            self._lease_id = await self.store.grant_lease(ttl)
            self._keepalive_task = asyncio.get_running_loop().create_task(
                self._keepalive_loop(self._lease_id, ttl / 3.0)
            )
        return self._lease_id

    async def _keepalive_loop(self, lease_id: int, interval: float) -> None:
        try:
            while not self._shutdown.is_set():
                await asyncio.sleep(interval)
                try:
                    await self.store.keep_alive(lease_id)
                except Exception as e:  # noqa: BLE001 — keepalive must outlive transient store errors; a missed beat only shortens the lease
                    log.warning("lease keepalive failed: %s", e)
        except asyncio.CancelledError:
            pass

    async def _ensure_server(self) -> EndpointServer:
        if self._server is None:
            from dynamo_tpu_torch.runtime.chaos import ChaosInjector

            chaos = ChaosInjector.from_config(self.config.chaos)
            if chaos is not None:
                chaos.bind_metrics(self.metrics)
            self._server = await EndpointServer(
                advertise_host=self._advertise_host,
                max_inflight=self.config.runtime.max_inflight,
                chaos=chaos,
                metrics=self.metrics,
                lane=self.proc_label,
            ).start()
        return self._server

    async def _serve(
        self, endpoint: Endpoint, handler: Handler, drain_timeout: float | None = None
    ) -> ServeHandle:
        server = await self._ensure_server()
        lease_id = await self.primary_lease()
        server.register(endpoint.subject, handler)
        inst = Instance(
            namespace=endpoint.namespace,
            component=endpoint.component.name,
            endpoint=endpoint.name,
            instance_id=lease_id,
            host=server.advertise_host,
            port=server.port,
        )
        key = instance_key(inst.namespace, inst.component, inst.endpoint, lease_id)
        await self.store.put(key, inst.to_bytes(), lease_id=lease_id)
        self.health.set_endpoint_health(endpoint.subject, True)
        handle = ServeHandle(self, inst, key, drain_timeout)
        self._handles.append(handle)
        log.info("serving %s as instance %x at %s:%d", endpoint.subject, lease_id, inst.host, inst.port)
        return handle

    async def _discovery(self, ns: str, comp: str, ep: str) -> DiscoveryClient:
        key = (ns, comp, ep)
        client = self._discoveries.get(key)
        if client is None:
            client = DiscoveryClient(
                self.store, ns, comp, ep,
                circuit_cooldown=self.config.runtime.circuit_cooldown,
                metrics=self.metrics,
            )
            await client.start()
            self._discoveries[key] = client
        return client

    async def shutdown(self) -> None:
        """Graceful: deregister instances, drain, drop lease, close planes."""
        if self._system_server is not None:
            await self._system_server.close()
            self._system_server = None
        self._shutdown.set()
        for handle in list(self._handles):
            await handle.close()
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self._lease_id is not None:
            with contextlib.suppress(Exception):
                await self.store.revoke_lease(self._lease_id)
        for d in self._discoveries.values():
            await d.close()
        await self.messaging.close()
        if self._server is not None:
            await self._server.close()
        tracing.remove_metrics_sink(self._tracing_sink)
        self.health.live = False
