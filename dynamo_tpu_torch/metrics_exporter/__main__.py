"""Metrics exporter: `python -m dynamo_tpu_torch.metrics_exporter`.

Fleet-level observability component (reference: components/metrics/src/
main.rs:20-35 — a Prometheus exporter that scrapes every worker's
load_metrics and aggregates KV-hit-rate events). Here it polls each
discovered worker's ``load_metrics`` endpoint over the runtime's request
plane and serves per-worker + aggregate gauges on its own /metrics port;
router-side hit-rate series live on the frontend's /metrics
(llm/pipeline.py), and deploy/metrics/dashboard.json charts both.

Port of ``dynamo_tpu/metrics_exporter/__main__.py``: /metrics is served
by ``runtime/http_server.py`` (aiohttp is absent on the card's machine),
and ``--port 0`` prints the port the OS chose.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal

from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.kv_router.publisher import LOAD_METRICS_ENDPOINT
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.push_router import RouterMode

log = get_logger("metrics_exporter")


class MetricsExporter:
    """Polls worker load metrics into a registry; caller serves it."""

    def __init__(self, runtime, namespace: str, component: str,
                 registry: MetricsRegistry | None = None,
                 interval_s: float = 5.0, scrape_timeout_s: float = 3.0):
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.registry = registry or runtime.metrics
        self.interval_s = interval_s
        # Per-worker scrape budget: workers are scraped concurrently and a
        # hung one costs at most this, not the whole poll loop (satellite
        # fix — sequential scraping let one dead worker stall the loop
        # past interval_s × fleet size).
        self.scrape_timeout_s = scrape_timeout_s
        self.g_active = self.registry.gauge("fleet_worker_active_slots", "Active request slots")
        self.g_total = self.registry.gauge("fleet_worker_total_slots", "Total request slots")
        self.g_waiting = self.registry.gauge("fleet_worker_waiting", "Queued requests")
        self.g_kv_active = self.registry.gauge("fleet_worker_kv_active_blocks", "Active KV blocks")
        self.g_kv_total = self.registry.gauge("fleet_worker_kv_total_blocks", "Total KV blocks")
        self.g_usage = self.registry.gauge("fleet_worker_kv_usage", "KV cache usage fraction")
        self.g_hit = self.registry.gauge("fleet_worker_prefix_hit_rate", "Worker-reported prefix hit rate")
        self.g_workers = self.registry.gauge("fleet_workers_live", "Discovered workers")
        self._router = None
        self._task: asyncio.Task | None = None
        self.polls = 0
        self._seen: set[str] = set()  # worker ids with live series

    async def start(self) -> "MetricsExporter":
        ep = (
            self.runtime.namespace(self.namespace)
            .component(self.component)
            .endpoint(LOAD_METRICS_ENDPOINT)
        )
        self._router = await ep.router(RouterMode.DIRECT)
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task

    async def _scrape_one(self, inst) -> "ForwardPassMetrics | None":
        """One worker's load metrics, bounded by scrape_timeout_s (the
        deadline travels to the worker, so a hung one is abandoned there
        too, not just here)."""
        wid = f"{inst.instance_id:x}"
        try:
            snap = None
            ctx = Context.with_timeout(self.scrape_timeout_s)
            async for item in self._router.generate(
                {}, ctx, instance_id=inst.instance_id
            ):
                snap = item
            if snap is None:
                return None
            return ForwardPassMetrics.from_dict(snap)
        except Exception as e:  # noqa: BLE001 — a dead worker must not kill the loop
            log.warning("scrape of worker %s failed: %s", wid, e)
            return None

    async def poll_once(self) -> int:
        """Scrape every live worker once, concurrently. → number scraped."""
        instances = list(self._router.discovery.available())
        self.g_workers.set(len(instances), component=self.component)
        live_ids = {f"{i.instance_id:x}" for i in instances}
        for gone in self._seen - live_ids:
            lbl = {"component": self.component, "worker": gone}
            for g in (self.g_active, self.g_total, self.g_waiting, self.g_kv_active,
                      self.g_kv_total, self.g_usage, self.g_hit):
                g.remove(**lbl)
        self._seen = live_ids
        # wait_for backstops the context deadline (covers a scrape stuck
        # before the deadline is even consulted, e.g. in connect).
        snaps = await asyncio.gather(*(
            asyncio.wait_for(self._scrape_one(inst), self.scrape_timeout_s + 1.0)
            for inst in instances
        ), return_exceptions=True)
        n = 0
        for inst, m in zip(instances, snaps):
            if isinstance(m, BaseException):
                log.warning("scrape of worker %x timed out", inst.instance_id)
                continue
            if m is None:
                continue
            lbl = {"component": self.component, "worker": f"{inst.instance_id:x}"}
            self.g_active.set(m.worker.request_active_slots, **lbl)
            self.g_total.set(m.worker.request_total_slots, **lbl)
            self.g_waiting.set(m.worker.num_requests_waiting, **lbl)
            self.g_kv_active.set(m.kv.kv_active_blocks, **lbl)
            self.g_kv_total.set(m.kv.kv_total_blocks, **lbl)
            self.g_usage.set(m.kv.gpu_cache_usage_perc, **lbl)
            self.g_hit.set(m.kv.gpu_prefix_cache_hit_rate, **lbl)
            n += 1
        self.polls += 1
        return n

    async def _loop(self) -> None:
        while True:
            try:
                await self.poll_once()
            except Exception:  # noqa: BLE001
                log.exception("fleet poll failed")
            await asyncio.sleep(self.interval_s)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.metrics_exporter")
    p.add_argument("--store-url", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9091)
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--scrape-timeout", type=float, default=3.0,
                   help="per-worker scrape budget (workers are scraped concurrently)")
    return p.parse_args(argv)


async def async_main(args) -> None:
    from dynamo_tpu_torch.runtime import http_server as web

    rt = await DistributedRuntime.create(store_url=args.store_url)
    exporter = await MetricsExporter(
        rt, args.namespace, args.component, interval_s=args.interval,
        scrape_timeout_s=args.scrape_timeout,
    ).start()

    async def handle_metrics(request):
        return web.Response(text=rt.metrics.render(), content_type="text/plain")

    app = web.Application()
    app.router.add_get("/metrics", handle_metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, args.host, args.port)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]  # --port 0: the port the OS chose
    print(f"dynamo_tpu metrics exporter: http://{args.host}:{port}/metrics", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await exporter.stop()
    await runner.cleanup()
    await rt.shutdown()


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
