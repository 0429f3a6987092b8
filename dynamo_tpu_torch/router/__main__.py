"""Standalone KV-router component: `python -m dynamo_tpu_torch.router`.

Reference analogue: components/router/src/main.rs:27-115 — a router
service other components query for placement decisions (worker id +
overlap) without the frontend in the path. Serves two endpoints on its
own component:

- ``route``: one-shot placement — {token_ids} → {worker_instance_id,
  overlap_blocks} (the reference's `generate` returning the chosen
  worker id).
- ``generate``: full routed proxy — forwards the request to the chosen
  backend worker and relays its stream (so lightweight clients get
  KV-aware routing without running the scheduler themselves).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal

from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import RouterMode

log = get_logger("router")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.router")
    p.add_argument("--store-url", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="router", help="component THIS service registers as")
    p.add_argument("--backend-component", default="backend", help="worker component to route over")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true")
    p.add_argument("--index-shards", type=int, default=0,
                   help="KV index shard threads (0 = in-loop; reference: KvIndexerSharded)")
    p.add_argument("--shortlist-k", type=int, default=16,
                   help="candidate pruning: top-k holder shortlist + least-loaded "
                        "workers only (0 = legacy full scan)")
    return p.parse_args(argv)


async def async_main(args) -> None:
    rt = await DistributedRuntime.create(store_url=args.store_url)
    backend_ep = (
        rt.namespace(args.namespace).component(args.backend_component).endpoint(args.endpoint)
    )
    push = await backend_ep.router(RouterMode.DIRECT)
    kv = await KvPushRouter(
        push,
        KvRouterConfig(
            block_size=args.block_size,
            overlap_score_weight=args.kv_overlap_score_weight,
            router_temperature=args.router_temperature,
            use_kv_events=not args.no_kv_events,
            index_shards=args.index_shards,
            shortlist_k=args.shortlist_k,
        ),
    ).start()

    async def route(payload, ctx):
        from dynamo_tpu_torch.runtime.push_router import NoInstancesError

        tokens = list((payload or {}).get("token_ids") or [])
        try:
            wid, overlap = kv.find_best_match(tokens)
        except NoInstancesError:
            yield {"error": "no available workers"}
            return
        yield {"worker_instance_id": wid, "overlap_blocks": overlap}

    async def generate(payload, ctx):
        async for item in kv.generate(payload, ctx):
            yield item

    try:
        comp = rt.namespace(args.namespace).component(args.component)
        await comp.endpoint("route").serve(route)
        await comp.endpoint(args.endpoint).serve(generate)
        print(
            f"dynamo_tpu router: {args.namespace}/{args.component} routing over "
            f"{args.backend_component}/{args.endpoint}",
            flush=True,
        )

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, stop.set)
        await stop.wait()
    finally:
        # Cancellation must still tear down subscriptions + deregister.
        await kv.close()
        await rt.shutdown()


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
