"""Frontend CLI: ``python -m dynamo_tpu_torch.frontend`` (port of
``dynamo_tpu/frontend/__main__.py`` without the frontend fleet).

One process: the store client, model discovery (``ModelManager`` /
``ModelWatcher``), a pipeline per discovered model (preprocessor →
router → migration → detokenizing backend) and the OpenAI HTTP service.
Flags mirror the JAX frontend's router mode and admission control; the
KV router runs with the JAX defaults (overlap weight 1, temperature 0,
worker KV events, one in-loop index).

SIGTERM drains: new requests get 503 + Retry-After while in-flight
streams run to completion, then the planes are torn down.

Not ported yet (ROADMAP A19): ``--fleet`` (the fleet supervisor, shared
budgets and decision cache), trace export, the router tuning flags
(``--kv-overlap-score-weight``, ``--router-temperature``,
``--no-kv-events``, ``--index-shards``, ``--shortlist-k``),
``--record-dir`` and the QoS classes (``--qos``, ``--qos-profile``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import signal

from dynamo_tpu_torch.kv_router.router import KvRouterConfig
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.pipeline import RouterSettings
from dynamo_tpu_torch.runtime.admission import AdmissionController
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import RouterMode

log = get_logger("frontend")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.frontend")
    p.add_argument("--store-url", default=None, help="control-plane store (tcp://host:port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--namespace", default=None, help="only serve models from this namespace")
    p.add_argument(
        "--router-mode", choices=["round-robin", "random", "kv"], default="round-robin"
    )
    # Admission control (overrides for the [admission]/[runtime] config
    # sections).
    p.add_argument("--max-inflight", type=int, default=None,
                   help="max concurrent inference requests before shedding "
                        "429s (default: DYNTPU_ADMISSION_MAX_INFLIGHT; 0 = unlimited)")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="extra requests allowed to wait for a slot before shedding")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="default end-to-end deadline (s) when the client "
                        "sends no X-Request-Timeout (0 = none)")
    return p.parse_args(argv)


async def async_main(args) -> None:
    from dynamo_tpu_torch.runtime import tracing

    lane = "frontend"
    tracing.set_default_lane(lane)
    rt = await DistributedRuntime.create(store_url=args.store_url, proc_label=lane)

    settings = RouterSettings(mode=RouterMode(args.router_mode))
    if settings.mode == RouterMode.KV:
        settings.kv = KvRouterConfig()

    acfg = rt.config.admission
    manager = ModelManager(rt, settings)
    watcher = await ModelWatcher(rt, manager, namespace=args.namespace).start()
    admission = AdmissionController(
        max_inflight=acfg.max_inflight if args.max_inflight is None else args.max_inflight,
        max_queue_depth=(acfg.max_queue_depth if args.max_queue_depth is None
                         else args.max_queue_depth),
        retry_after=acfg.retry_after,
        queue_timeout=acfg.queue_timeout,
    )
    default_timeout = (
        rt.config.runtime.default_request_timeout
        if args.request_timeout is None
        else args.request_timeout
    )
    http = await HttpService(
        manager, rt.metrics, health=rt.health, host=args.host, port=args.port,
        admission=admission, default_timeout=default_timeout, proc_label=lane,
    ).start()
    print(f"dynamo_tpu_torch frontend: http://{args.host}:{http.port}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal() -> None:
        if stop.is_set():
            # Second signal: the operator wants out now — skip the drain.
            log.warning("second signal during drain: forcing exit")
            os._exit(130)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, on_signal)
    await stop.wait()
    # Graceful drain: stop admitting (503 + Retry-After), let in-flight
    # streams run to completion, then tear the planes down.
    log.info("frontend draining (%d in flight)", admission.inflight)
    http.start_draining()
    if not await http.wait_drained(rt.config.runtime.graceful_shutdown_timeout):
        log.warning("drain timeout: %d streams still in flight at shutdown", admission.inflight)

    async def teardown() -> None:
        await http.close()
        log.info("frontend shutting down")
        await watcher.close()
        await manager.close()
        await rt.shutdown()

    try:
        # Bounded: clients are served; teardown must not hang the process
        # on a dead control plane (lease-backed keys self-clean via TTL).
        await asyncio.wait_for(teardown(), timeout=15.0)
    except Exception as e:  # noqa: BLE001 — exit anyway (incl. teardown timeout)
        log.warning("teardown incomplete (%s: %s); exiting", type(e).__name__, e)
        os._exit(0)


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
