"""TorchEngine's tracing spans against TpuEngine's.

One traced request at a time through both engines (test-tiny, float32,
the same numpy weights from seed 0), each package under a fresh span
recorder: a cold request, the same prompt again as a prefix hit, and a
stream cancelled after its first delta. Both must record the same spans:
``engine.queue``, ``engine.prefill`` (``prompt_tokens``, ``cached_blocks``)
and ``engine.decode`` (``tokens``; status ``cancelled`` on the cancelled
stream), each a child of the request's trace context, and the same
``build_ledger`` phases. Then the serving path: a port worker behind a
port frontend in one process (the shape of
tests/test_observability_e2e.py's ledger test for a JAX worker), whose
``/debug/requests`` record carries the engine phases and whose flame nests
the engine spans under the wire and router spans; and a port worker
process behind a port fleet of one frontend with trace export, whose
aggregated ``/debug/requests`` carries them too.
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.logging import TraceContext as JTrace
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.client import OpenAIClient
from dynamo_tpu_torch.runtime import tracing as ttracing
from dynamo_tpu_torch.runtime.engine import Context as TContext
from dynamo_tpu_torch.runtime.logging import TraceContext as TTrace
from procutil import ManagedProcess

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", pipeline_depth=0)
PROMPT = list(range(20, 43))  # 23 tokens: 5 full blocks are matchable on a repeat
TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
PARENT = "b7ad6b7169203331"
TRACEPARENT = f"00-{TRACE_ID}-{PARENT}-01"
ENGINE_SPANS = ("engine.queue", "engine.prefill", "engine.decode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorders():
    """A fresh recorder in each package → (JAX's, the port's)."""
    rj = jtracing.SpanRecorder(capacity=4096, ledger_capacity=256)
    rt = ttracing.SpanRecorder(capacity=4096, ledger_capacity=256)
    pj, pt = jtracing.set_recorder(rj), ttracing.set_recorder(rt)
    yield rj, rt
    jtracing.set_recorder(pj)
    ttracing.set_recorder(pt)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def request(max_tokens: int) -> dict:
    return {"model": "test-tiny", "token_ids": list(PROMPT),
            "sampling": {"temperature": 0.0, "seed": 0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


async def traced(engine, ctx, max_tokens: int, cancel: bool = False) -> int:
    """One traced request → tokens the stream delivered. ``cancel``: the
    context is cancelled after the first delta and the stream drained."""
    n = 0
    async for item in engine.generate(request(max_tokens), ctx):
        n += len(item.get("token_ids") or ())
        if cancel and not ctx.cancelled:
            ctx.cancel()
    return n


def view(spans) -> list[dict]:
    """The engine spans, comparably: name, parent, status and attributes
    (a cancelled stream's token count depends on when its cancel landed,
    so it is left to the caller)."""
    out = []
    for s in sorted((s for s in spans if s.name in ENGINE_SPANS), key=lambda s: s.name):
        assert s.duration_s is not None and s.duration_s >= 0
        out.append({"name": s.name, "parent": s.parent_id, "status": s.status,
                    "attrs": dict(s.attrs)})
    return out


# The three requests, each under its own trace: (max_tokens, cancel).
CASES = {"cold": (6, False), "prefix_hit": (6, False), "cancelled": (60, True)}


def trace_of(case: str) -> str:
    return f"{list(CASES).index(case) + 1:032x}"


def run_engine(engine, ctx_cls, trace_cls) -> dict:
    """The three requests in turn → tokens each stream delivered."""
    async def go():
        await engine.start()
        try:
            got = {}
            for case, (max_tokens, cancel) in CASES.items():
                ctx = ctx_cls(trace=trace_cls.parse(f"00-{trace_of(case)}-{PARENT}-01"))
                got[case] = await asyncio.wait_for(traced(engine, ctx, max_tokens, cancel), 60)
            return got
        finally:
            await engine.stop()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def both(np_params):
    """Both engines through the three requests, each package under a fresh
    recorder → {"jax"|"port": (recorder, delivered tokens by case)}."""
    rj = jtracing.SpanRecorder(capacity=4096, ledger_capacity=256)
    rt = ttracing.SpanRecorder(capacity=4096, ledger_capacity=256)
    pj, pt = jtracing.set_recorder(rj), ttracing.set_recorder(rt)
    try:
        jd = run_engine(TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **ARGS),
                                  params=np_params), JContext, JTrace)
        td = run_engine(TorchEngine(TArgs(model=TCfg(), device="cpu", **ARGS),
                                    params=params_from_numpy(np_params, "cpu", torch.float32)),
                        TContext, TTrace)
    finally:
        jtracing.set_recorder(pj)
        ttracing.set_recorder(pt)
    return {"jax": (rj, jd), "port": (rt, td)}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_spans_equal_the_jax_engines(both, case):
    """Cold: no cached block. The same prompt again: a prefix hit of the
    prompt's 5 full matchable blocks (23 tokens, block size 4). A stream
    cancelled after its first delta (on the same prefix): its decode span
    ends ``cancelled`` with the tokens the engine emitted by then."""
    tid = trace_of(case)
    views = {tag: view(rec.spans(tid)) for tag, (rec, _) in both.items()}
    j, t = views["jax"], views["port"]
    assert [v["name"] for v in t] == sorted(ENGINE_SPANS)
    assert [(v["name"], v["parent"], v["status"]) for v in j] == \
        [(v["name"], v["parent"], v["status"]) for v in t]
    assert {v["parent"] for v in t} == {PARENT}
    pre = {tag: next(v["attrs"] for v in vs if v["name"] == "engine.prefill")
           for tag, vs in views.items()}
    assert pre["jax"] == pre["port"] == {
        "prompt_tokens": len(PROMPT), "cached_blocks": 0 if case == "cold" else 5}
    for tag, vs in views.items():
        dec = next(v for v in vs if v["name"] == "engine.decode")
        assert set(dec["attrs"]) == {"tokens"}
        delivered = both[tag][1][case]
        if case == "cancelled":
            assert dec["status"] == "cancelled"
            assert delivered <= dec["attrs"]["tokens"] < CASES[case][0], (tag, dec, delivered)
        else:
            assert dec["status"] == "ok" and dec["attrs"]["tokens"] == delivered == 6
        assert {v["name"] for v in vs if v["name"] != "engine.decode"} == {"engine.queue",
                                                                           "engine.prefill"}
        assert all(v["attrs"] == {} for v in vs if v["name"] == "engine.queue")
    # The ledger both packages derive from these spans.
    ledgers = [tr.build_ledger(tid, request_id="r", model="m", endpoint="completions",
                               status="200", duration_s=1.0, spans=both[tag][0].spans(tid))
               for tr, tag in ((jtracing, "jax"), (ttracing, "port"))]
    assert set(ledgers[0]["phases"]) == set(ledgers[1]["phases"]) == {
        "queue_wait", "prefill", "decode"}
    assert all(v > 0 for v in ledgers[1]["phases"].values())


def test_untraced_request_records_no_span(np_params, recorders):
    _rj, rt = recorders
    engine = TorchEngine(TArgs(model=TCfg(), device="cpu", **ARGS),
                         params=params_from_numpy(np_params, "cpu", torch.float32))

    async def go():
        await engine.start()
        try:
            return await asyncio.wait_for(traced(engine, TContext(), 4), 60)
        finally:
            await engine.stop()

    assert asyncio.run(go()) == 4
    assert rt.spans() == [] and engine.traced_requests == 0 and engine.trace_s == 0.0


def span_index(trace_json):
    return {e["args"]["span_id"]: e for e in trace_json["traceEvents"] if e["ph"] == "X"}


def ancestors(spans, event):
    chain, parent = [], event["args"]["parent_id"]
    while parent is not None and parent in spans:
        event = spans[parent]
        chain.append(event["name"])
        parent = event["args"]["parent_id"]
    return chain


def test_port_worker_behind_port_frontend_ledger_and_flame(np_params, recorders):
    """tests/test_observability_e2e.py's ledger test, on the port: a
    TorchEngine worker and the port's frontend on one store in this
    process (one recorder), a traced chat → the /debug/requests record
    carries every phase, the engine's among them, and the flame nests
    engine.decode under wire.serve → wire.call → router.attempt →
    http.request."""
    from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster, serve_kv_endpoints
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_model
    from dynamo_tpu_torch.llm.pipeline import RouterSettings
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.config import Config
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.push_router import RouterMode

    _rj, rt = recorders
    url = "memory://torch_spans_e2e"

    async def go():
        wrt = await DistributedRuntime.create(store_url=url, config=Config.from_env({}))
        engine = await TorchEngine(TArgs(model=TCfg(), device="cpu", **ARGS),
                                   params=params_from_numpy(np_params, "cpu",
                                                            torch.float32)).start()
        broadcaster = KvEventBroadcaster(engine.pool)
        engine.pool.set_event_sink(broadcaster.publish)
        comp = wrt.namespace("obs").component("backend")

        async def gen(payload, ctx):
            async for item in engine.generate(payload, ctx):
                yield item

        await comp.endpoint("generate").serve(gen)
        await serve_kv_endpoints(comp, broadcaster, engine.metrics)
        await register_model(wrt, "obs", ModelDeploymentCard(
            name="obs-model", kv_cache_block_size=4, eos_token_ids=[ByteTokenizer.EOS],
            context_length=128))
        frt = await DistributedRuntime.create(store_url=url, config=Config.from_env({}))
        manager = ModelManager(frt, RouterSettings(mode=RouterMode.ROUND_ROBIN))
        watcher = await ModelWatcher(frt, manager).start()
        http = await HttpService(manager, frt.metrics, health=frt.health, host="127.0.0.1",
                                 port=0).start()
        base = f"http://127.0.0.1:{http.port}"
        try:
            async with OpenAIClient(base, default_model="obs-model",
                                    headers={"traceparent": TRACEPARENT}) as c:
                for _ in range(100):
                    if await c.models():
                        break
                    await asyncio.sleep(0.05)
                out = await c.chat([{"role": "user", "content": "observe me"}], max_tokens=8,
                                   temperature=0.0, seed=0, ignore_eos=True)
                assert out["usage"]["completion_tokens"] == 8
                records = (await c.get(f"/debug/requests?trace_id={TRACE_ID}")).json()
                flame = (await c.get(f"/debug/traces/{TRACE_ID}")).json()
            return records["requests"], flame
        finally:
            await http.close()
            await watcher.close()
            await manager.close()
            await frt.shutdown()
            await wrt.shutdown()
            await engine.stop()
            await wrt.store.close()

    records, flame = asyncio.run(asyncio.wait_for(go(), 120))
    assert len(records) == 1 and records[0]["status"] == "200"
    for phase in ("admission_wait", "preprocess", "route", "wire", "queue_wait", "prefill",
                  "decode"):
        assert records[0]["phases"].get(phase, 0) > 0, (phase, records[0]["phases"])
    spans = span_index(flame)
    decode = next(e for e in spans.values() if e["name"] == "engine.decode")
    assert ancestors(spans, decode)[:4] == ["wire.serve", "wire.call", "router.attempt",
                                            "http.request"]
    assert decode["args"]["tokens"] == 8
    prefill = next(e for e in spans.values() if e["name"] == "engine.prefill")
    assert prefill["args"]["cached_blocks"] == 0 and prefill["args"]["prompt_tokens"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_port_worker_process_phases_reach_the_fleet_ledger():
    """A port worker process (TorchEngine, trace export, a G2 tier and
    ``--kv-directory on``) behind a port fleet of one frontend (trace
    export): the supervisor's aggregated /debug/requests record of a traced
    request carries the worker's engine phases, the stitched trace holds the
    worker's lane, and the prefix directory lists the request's blocks in
    G1, then, once G1 is cleared, in G2."""
    from dynamo_tpu_torch.fleet.directory import kvdir_prefix
    from dynamo_tpu_torch.runtime.store import connect_store

    env = {"DYNTPU_TRACE_EXPORT": "1", "DYNTPU_FLEET_ID": "spans", "OMP_NUM_THREADS": "1",
           "DYNTPU_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT": "10"}
    sp = _free_port()
    url = f"tcp://127.0.0.1:{sp}"
    procs = []
    try:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(sp)], name="store", env=env)
        procs.append(store)
        store.wait_for(r"store server: tcp://")
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--store-url", url, "--device", "cpu",
             "--preset", "test-tiny", "--dtype", "float32", "--block-size", "4",
             "--num-kv-blocks", "64", "--max-num-seqs", "4", "--max-model-len", "128",
             "--host-kv-blocks", "32", "--kv-directory", "on"],
            name="worker", env=env)
        procs.append(worker)
        worker.wait_for(r"serving test-tiny", 120)
        fleet = ManagedProcess(
            ["-m", "dynamo_tpu_torch.frontend", "--store-url", url, "--host", "127.0.0.1",
             "--port", "0", "--fleet", "1", "--fleet-id", "spans"], name="fleet", env=env)
        procs.append(fleet)
        m = fleet.wait_for(r"fleet: http://127\.0\.0\.1:(\d+) admin http://127\.0\.0\.1:(\d+)", 60)
        fleet.wait_for(r"fleet ready", 60)
        base, admin = f"http://127.0.0.1:{m.group(1)}", f"http://127.0.0.1:{m.group(2)}"

        async def tiers_listed(store) -> set:
            """The directory's tiers for this worker, once it lists any."""
            for _ in range(100):
                entries = await store.get_prefix(kvdir_prefix("dynamo"))
                if entries:
                    return {tier for tier, _seq in json.loads(entries[0].value)["h"].values()}
                await asyncio.sleep(0.1)
            return set()

        async def go():
            store = await connect_store(url)
            async with OpenAIClient(base, default_model="test-tiny",
                                    headers={"traceparent": TRACEPARENT}) as c:
                for _ in range(200):
                    if await c.models():
                        break
                    await asyncio.sleep(0.05)
                # Past one 8-token window: the engine flushes offloads between
                # windows (a request that ends within its first offloads none).
                await c.completion("trace me, and keep my blocks in the tiers", max_tokens=24,
                                   temperature=0.0, seed=0, ignore_eos=True)
                assert 1 in await tiers_listed(store)
                await c.clear_kv_blocks()
                for _ in range(100):
                    if await tiers_listed(store) == {2}:
                        break
                    await asyncio.sleep(0.1)
                assert await tiers_listed(store) == {2}
            await store.close()
            async with OpenAIClient(admin) as a:
                for _ in range(100):
                    recs = [r for r in (await a.get("/debug/requests")).json()["requests"]
                            if r["trace_id"] == TRACE_ID]
                    if recs and {"queue_wait", "prefill", "decode"} <= set(recs[0]["phases"]):
                        break
                    await asyncio.sleep(0.1)
                trace = (await a.get(f"/debug/fleet/traces/{TRACE_ID}")).json()
            return recs, trace

        recs, trace = asyncio.run(asyncio.wait_for(go(), 120))
        assert len(recs) == 1
        for phase in ("route", "wire", "queue_wait", "prefill", "decode"):
            assert recs[0]["phases"].get(phase, 0) > 0, (phase, recs[0]["phases"])
        lanes = {d["proc"] for d in trace["spans"] if d["name"] in ENGINE_SPANS}
        assert lanes == {f"worker-{worker.proc.pid}"}
        dec = next(d for d in trace["spans"] if d["name"] == "engine.decode")
        assert dec["attrs"]["tokens"] == 24
        for p in (fleet, worker):
            p.proc.send_signal(signal.SIGTERM)
            assert p.proc.wait(60) == 0
        counters = json.loads(next(ln for ln in reversed(worker.proc.stdout.read().splitlines())
                                   if ln.startswith('{"event": "engine_counters"')))
        assert counters["trace"]["requests"] == 1 and counters["trace"]["exported_spans"] >= 4
    finally:
        for p in reversed(procs):
            p.terminate()
