"""The port's standalone router service and metrics exporter against the
JAX package's, over the same mocker workers on one TCP store.

- ``python -m dynamo_tpu.router`` and ``python -m dynamo_tpu_torch.router``
  (two components on one store) give the same ``route`` answers
  ({worker_instance_id, overlap_blocks}) for prompts cached on one worker
  or the other, the same overlap where both or neither hold the prompt
  (ties break at random), and their ``generate`` proxies
  stream the same tokens.
- A JAX and a port ``MetricsExporter`` polling the same workers render
  equal gauges, each worker's equal to what its own ``load_metrics``
  reports, and ``python -m dynamo_tpu_torch.metrics_exporter`` serves
  them on its own /metrics.
"""

from __future__ import annotations

import asyncio
import re
import socket
import urllib.request

from procutil import ManagedProcess

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode

MOCKER = ["--engine", "mocker", "--mocker-ttft-ms", "1", "--mocker-itl-ms", "1",
          "--block-size", "4", "--num-kv-blocks", "256", "--max-num-seqs", "4"]
PER_WORKER = ("fleet_worker_active_slots", "fleet_worker_total_slots", "fleet_worker_waiting",
              "fleet_worker_kv_active_blocks", "fleet_worker_kv_total_blocks",
              "fleet_worker_kv_usage", "fleet_worker_prefix_hit_rate", "fleet_workers_live")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(tokens, n=6):
    return {"model": "mock-model", "token_ids": tokens,
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": n, "ignore_eos": True}}


def gauges(text: str, names) -> dict:
    out = {}
    for line in text.splitlines():
        m = re.match(r"^(?:dynamo_tpu_)?([a-z_]+)(\{[^}]*\})? (\S+)$", line)
        if m and m.group(1) in names:
            out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def test_router_services_and_exporters_agree():
    port = _free_port()
    url = f"tcp://127.0.0.1:{port}"
    procs = []
    try:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(port)], name="store")
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        for i in range(2):
            w = ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", url, *MOCKER],
                               name=f"mocker{i}")
            procs.append(w)
            w.wait_for(r"serving mock-model", 60)
        for pkg, comp in (("dynamo_tpu", "router_jax"), ("dynamo_tpu_torch", "router_port")):
            r = ManagedProcess(["-m", f"{pkg}.router", "--store-url", url, "--component", comp,
                                "--block-size", "4"], name=comp)
            procs.append(r)
            r.wait_for(r"router: dynamo/" + comp, 60)
        exp = ManagedProcess(["-m", "dynamo_tpu_torch.metrics_exporter", "--store-url", url,
                              "--host", "127.0.0.1", "--port", "0", "--interval", "0.2"],
                             name="exporter")
        procs.append(exp)
        exp_port = int(exp.wait_for(r"metrics exporter: http://127\.0\.0\.1:(\d+)/metrics",
                                    60).group(1))
        asyncio.run(_drive(url, exp_port))
    finally:
        for p in procs:
            p.kill()


async def _drive(url: str, exp_port: int) -> None:
    from dynamo_tpu.metrics_exporter import MetricsExporter as JExporter
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
    from dynamo_tpu_torch.metrics_exporter import MetricsExporter as TExporter

    rt = await DistributedRuntime.create(store_url=url)
    ns = rt.namespace("dynamo")
    backend = await ns.component("backend").endpoint("generate").router(RouterMode.DIRECT)
    routers = {}
    for comp in ("router_jax", "router_port"):
        routers[comp] = {ep: await ns.component(comp).endpoint(ep).router()
                         for ep in ("route", "generate")}
    await backend.discovery.wait_for_instances(2)
    for r in routers.values():
        for ep in r.values():
            await ep.discovery.wait_for_instances(1)
    workers = sorted(i.instance_id for i in backend.discovery.available())

    async def collect(agen):
        out = []
        async for item in agen:
            out.append(item)
        return out

    # Cache one prompt on each worker (direct), one on both.
    prompts = {"a": list(range(10, 42)), "b": list(range(100, 140)), "both": list(range(300, 333))}
    await collect(backend.generate(request(prompts["a"]), Context(), instance_id=workers[0]))
    await collect(backend.generate(request(prompts["b"]), Context(), instance_id=workers[1]))
    for w in workers:
        await collect(backend.generate(request(prompts["both"]), Context(), instance_id=w))
    await asyncio.sleep(0.5)  # the routers' indexes take the KV events

    queries = {**prompts, "a+": prompts["a"] + [7, 7, 7, 7, 7], "none": list(range(500, 520)),
               "short": [1, 2]}
    answers = {}
    for comp, r in routers.items():
        answers[comp] = {k: (await collect(r["route"].generate({"token_ids": q}, Context())))[0]
                         for k, q in queries.items()}
    # Where the overlap decides, the whole answer is the same; where it
    # ties (cached on both, or on neither), both routers break the tie at
    # random among the tied workers: the overlap is the same.
    for k in queries:
        want, have = answers["router_jax"][k], answers["router_port"][k]
        assert have["overlap_blocks"] == want["overlap_blocks"], k
        if k in ("a", "a+", "b"):
            assert have == want, k
        assert have["worker_instance_id"] in workers
    got = answers["router_port"]
    # Full prompt blocks of 4 tokens: 32 / 4, 40 / 4, 33 // 4.
    assert got["a"] == {"worker_instance_id": workers[0], "overlap_blocks": 8}
    assert got["a+"] == got["a"]
    assert got["b"] == {"worker_instance_id": workers[1], "overlap_blocks": 10}
    assert got["both"]["overlap_blocks"] == 8 and got["none"]["overlap_blocks"] == 0

    streams = {}
    for comp, r in routers.items():
        frames = await collect(r["generate"].generate(request(prompts["b"], n=9), Context()))
        streams[comp] = [t for f in frames for t in f.get("token_ids") or []]
    assert streams["router_port"] == streams["router_jax"] and len(streams["router_jax"]) == 9

    # Exporters: the JAX one and the port one over the same workers.
    texts = {}
    for name, rt_cls, exp_cls in (("jax", JRuntime, JExporter), ("port", DistributedRuntime,
                                                                  TExporter)):
        ert = await rt_cls.create(store_url=url)
        exporter = await exp_cls(ert, "dynamo", "backend", interval_s=3600).start()
        await exporter._router.discovery.wait_for_instances(2)
        assert await exporter.poll_once() == 2
        await exporter.stop()
        texts[name] = ert.metrics.render()
        await ert.shutdown()
        await ert.store.close()
    jg, tg = gauges(texts["jax"], PER_WORKER), gauges(texts["port"], PER_WORKER)
    assert tg == jg and len(tg) == 7 * 2 + 1
    assert tg['fleet_workers_live{component="backend"}'] == 2
    load = await ns.component("backend").endpoint("load_metrics").router(RouterMode.DIRECT)
    for w in workers:
        snap = (await collect(load.generate({}, Context(), instance_id=w)))[-1]
        lbl = f'{{component="backend",worker="{w:x}"}}'
        assert tg["fleet_worker_total_slots" + lbl] == snap["worker"]["request_total_slots"] == 4
        assert tg["fleet_worker_kv_total_blocks" + lbl] == snap["kv"]["kv_total_blocks"] > 0
        assert tg["fleet_worker_kv_active_blocks" + lbl] == snap["kv"]["kv_active_blocks"]

    # The CLI serves the same series on its own port, once a poll of its
    # has run after the streams above ended (one during them reads a
    # worker's active slot and blocks).
    for _ in range(50):
        served = gauges(await asyncio.to_thread(
            lambda: urllib.request.urlopen(f"http://127.0.0.1:{exp_port}/metrics",
                                           timeout=10).read().decode()), PER_WORKER)
        if served == tg:
            break
        await asyncio.sleep(0.1)
    assert served == tg
    await rt.shutdown()
    await rt.store.close()
