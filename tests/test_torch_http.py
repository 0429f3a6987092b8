"""The port's OpenAI HTTP surface against the JAX package's, on the CPU.

Two serving stacks run in one process and one event loop, each wholly
from its own package: a TCP store server, a worker runtime serving the
engine's ``generate`` (plus KV-event and load-metrics endpoints) and
registering the model card, and a frontend runtime with ModelManager /
ModelWatcher and ``HttpService`` — the JAX one over ``TpuEngine`` (XLA
attention), the port's over ``TorchEngine``, both on the same numpy
weights (test-tiny, float32, depth 2, K 4).

The same requests go to both over HTTP: greedy and seeded sampled chat
and completions, streamed and aggregated, with ``logprobs`` /
``top_logprobs`` and stop strings. After dropping ``id``, ``created`` and
``system_fingerprint``, the bodies must be equal: token text,
``finish_reason`` and usage exactly, logprob values to atol = rtol =
1e-4 (the forward pass's float32 tolerance, tests/test_torch_pipeline.py).
Streams are compared event by event. Both engines run at the JAX
defaults, where a stream's consumer merges the deltas already queued for
it into one frame (``delta_max_tokens=64``): which deltas are queued when
it reads depends on the host's timing, in both packages. So the workers'
handler of the comparisons (``settle``) hands the engine's stream on only
once the engine has generated the whole request, with the event loop held:
every delta is then queued at the first read, both engines merge the same
frames, and requests go one at a time, so the SSE event sequences must be
equal.

Error paths give the same status and error type: unknown model 404, bad
body 400, ``X-Request-Timeout`` 504, ``max_inflight`` 429 with
Retry-After, draining 503, embeddings 501 (the workers here serve no
``embed`` endpoint). A ``response_format`` whose schema the grammar
compiler cannot express gets the same typed 400 from both. A client that
disconnects mid-stream leaves the port's engine with no running row.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import math
import threading
import time
from types import SimpleNamespace

import httpx
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.protocols import parse_sse_lines
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=256,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
MODEL = "tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
DROP = ("id", "created", "system_fingerprint")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


async def start_store(pkg: str):
    return await mod(pkg, "runtime.store_net").StoreServer().start()


def _settled(engine, g0: int, n: int, timeout: float = 60.0) -> None:
    """Block (the event loop too) until ``engine`` has generated ``n``
    tokens since ``g0`` and holds no request: every delta of the request
    is then posted, and none was delivered."""
    deadline = time.monotonic() + timeout
    while (engine.total_generated < g0 + n or engine._submissions or engine._waiting
           or engine._running or engine._fetchq):
        if time.monotonic() > deadline:
            raise TimeoutError("the engine did not finish the request")
        time.sleep(0.001)


async def settled_stream(engine, agen, max_tokens: int):
    """``agen`` (the engine's ``generate`` for a request that runs to
    ``max_tokens``), its first item read only once the engine has finished
    the request (``_settled``): every delta is queued by then, so the
    frames the consumer merges do not depend on timing."""
    g0 = engine.total_generated
    first = asyncio.ensure_future(agen.__anext__())
    await asyncio.sleep(0)  # generate() submits, then waits on its queue
    _settled(engine, g0, max_tokens)
    try:
        yield await first
    except StopAsyncIteration:
        return
    async for item in agen:
        yield item


async def start_worker(pkg: str, store_url: str, engine, name: str = MODEL,
                       namespace: str = "dynamo", block_size: int = 4,
                       settle: threading.Event | None = None, card=None):
    """A worker runtime serving ``engine`` as the JAX worker CLI wires it
    (generate + kv_events + load_metrics + clear_kv, model card: ``card``
    or one made here). While ``settle`` is set, a request that runs to its
    ``max_tokens`` (``ignore_eos``) is served by ``settled_stream``."""
    rt = await mod(pkg, "runtime.distributed").DistributedRuntime.create(store_url=store_url)
    pub = mod(pkg, "kv_router.publisher")
    mc = mod(pkg, "llm.model_card")
    broadcaster = pub.KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)
    comp = rt.namespace(namespace).component("backend")

    async def gen_handler(payload, ctx):
        stop = payload.get("stop") or {}
        agen = engine.generate(payload, ctx)
        if settle is not None and settle.is_set() and stop.get("ignore_eos") \
                and stop.get("max_tokens"):
            agen = settled_stream(engine, agen, stop["max_tokens"])
        async for item in agen:
            yield item

    async def clear_handler(payload, ctx):
        yield {"cleared": engine.clear_kv_blocks()}

    await comp.endpoint("generate").serve(gen_handler)
    await pub.serve_kv_endpoints(comp, broadcaster, engine.metrics)
    await comp.endpoint("clear_kv").serve(clear_handler)
    card = card or mc.ModelDeploymentCard(name=name, kv_cache_block_size=block_size,
                                          eos_token_ids=[257],
                                          context_length=BASE["max_model_len"])
    await mc.register_model(rt, namespace, card)
    return rt


async def start_frontend(pkg: str, store_url: str, mode: str = "round-robin", **http_kw):
    rt = await mod(pkg, "runtime.distributed").DistributedRuntime.create(store_url=store_url)
    disc = mod(pkg, "llm.discovery")
    RouterMode = mod(pkg, "runtime.push_router").RouterMode
    settings = mod(pkg, "llm.pipeline").RouterSettings(mode=RouterMode(mode))
    manager = disc.ModelManager(rt, settings)
    watcher = await disc.ModelWatcher(rt, manager).start()
    http = await mod(pkg, "llm.http_service").HttpService(
        manager, rt.metrics, health=rt.health, host="127.0.0.1", port=0, **http_kw).start()
    fe = SimpleNamespace(rt=rt, manager=manager, watcher=watcher, http=http,
                         base=f"http://127.0.0.1:{http.port}")
    return fe


async def stop_runtime(rt) -> None:
    """Shut a runtime down and close its store connection (a TCP store
    server's close waits for its clients to leave)."""
    await rt.shutdown()
    await rt.store.close()


async def stop_frontend(fe) -> None:
    await fe.http.close()
    await fe.watcher.close()
    await fe.manager.close()
    await stop_runtime(fe.rt)


async def wait_for_models(base: str, names, timeout: float = 20.0) -> None:
    async with httpx.AsyncClient(timeout=10) as c:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            r = await c.get(f"{base}/v1/models")
            if sorted(m["id"] for m in r.json()["data"]) == sorted(names):
                return
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"models {names} not listed: {r.json()}")
            await asyncio.sleep(0.05)


def np_weights():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", pipeline_depth=2, **{**BASE, **kw}),
                     params=np_params)


def port_engine(np_params, **kw) -> TorchEngine:
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", pipeline_depth=2,
                                  **{**BASE, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


# -- comparison ----------------------------------------------------------------


def strip_ids(obj):
    if isinstance(obj, dict):
        return {k: strip_ids(v) for k, v in obj.items() if k not in DROP}
    if isinstance(obj, list):
        return [strip_ids(v) for v in obj]
    return obj


def assert_close(a, b, path="$"):
    """Equal, with floats (logprob values) to atol = rtol = 1e-4."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        assert math.isclose(a, b, abs_tol=TOL["atol"], rel_tol=TOL["rtol"]), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def sse_events(raw: list[bytes]) -> list:
    """SSE body → its event sequence, ids dropped."""
    return [data if data == "[DONE]" else strip_ids(json.loads(data))
            for data in parse_sse_lines(raw)]


async def call(base: str, path: str, body, stream: bool, headers=None, raw_body=None):
    """→ (status, headers, parsed body or SSE event list)."""
    async with httpx.AsyncClient(timeout=60) as c:
        if stream:
            async with c.stream("POST", f"{base}{path}", json=body, headers=headers) as r:
                chunks = [x async for x in r.aiter_bytes()]
            if r.status_code != 200:
                return r.status_code, r.headers, json.loads(b"".join(chunks))
            return r.status_code, r.headers, sse_events(chunks)
        if raw_body is not None:
            r = await c.post(f"{base}{path}", content=raw_body, headers=headers)
        else:
            r = await c.post(f"{base}{path}", json=body, headers=headers)
        return r.status_code, r.headers, strip_ids(r.json())


# -- the two stacks ----------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """Both serving stacks on one event loop, for the whole module."""
    loop = asyncio.new_event_loop()
    np_params = np_weights()
    settle = threading.Event()  # set by the stream comparisons

    async def build():
        out = {"settle": settle}
        for pkg, make in (("dynamo_tpu", jax_engine), ("dynamo_tpu_torch", port_engine)):
            store = await start_store(pkg)
            engine = await make(np_params).start()
            wrt = await start_worker(pkg, store.url, engine, settle=settle)
            fe = await start_frontend(pkg, store.url)
            await wait_for_models(fe.base, [MODEL])
            out["jax" if pkg == "dynamo_tpu" else "port"] = SimpleNamespace(
                pkg=pkg, store=store, engine=engine, wrt=wrt, fe=fe, base=fe.base)
        return out

    s = loop.run_until_complete(build())
    s["run"] = loop.run_until_complete
    yield s

    async def teardown():
        for side in ("jax", "port"):
            st = s[side]
            await stop_frontend(st.fe)
            await stop_runtime(st.wrt)
            await st.engine.stop()
            await st.store.close()

    loop.run_until_complete(teardown())
    loop.close()


def with_settle(stacks, coro):
    """Run ``coro`` with the workers' ``settle`` gate set."""
    stacks["settle"].set()
    try:
        return stacks["run"](coro)
    finally:
        stacks["settle"].clear()


def chat(content, **kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": content}], **kw}


def completion(prompt, **kw):
    return {"model": MODEL, "prompt": prompt, **kw}


REQUESTS = {
    "chat_greedy_aggregate": ("/v1/chat/completions", chat(
        "Hello there, how are you?", max_tokens=12, temperature=0, seed=1, ignore_eos=True)),
    "chat_sampled_stream": ("/v1/chat/completions", chat(
        "Tell me a story.", max_tokens=14, temperature=0.8, seed=7, ignore_eos=True,
        stream=True)),
    "chat_logprobs_top_stream": ("/v1/chat/completions", chat(
        "logprobs please", max_tokens=10, temperature=0.7, seed=5, ignore_eos=True,
        logprobs=True, top_logprobs=3, stream=True)),
    "chat_logprobs_greedy_aggregate": ("/v1/chat/completions", chat(
        "greedy logprobs", max_tokens=9, temperature=0, seed=2, ignore_eos=True,
        logprobs=True, top_logprobs=2)),
    "completion_greedy_stream_logprobs": ("/v1/completions", completion(
        "hello world", max_tokens=10, temperature=0, seed=3, ignore_eos=True, logprobs=2,
        stream=True)),
    "completion_sampled_aggregate_logprobs": ("/v1/completions", completion(
        "sampling here", max_tokens=11, temperature=0.9, seed=11, ignore_eos=True,
        logprobs=0)),
    "completion_sampled_stream": ("/v1/completions", completion(
        "another prompt", max_tokens=13, temperature=1.0, seed=1000, ignore_eos=True,
        stream=True)),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_responses_equal_the_jax_service(stacks, name):
    path, body = REQUESTS[name]

    async def go():
        j = await call(stacks["jax"].base, path, body, body.get("stream", False))
        t = await call(stacks["port"].base, path, body, body.get("stream", False))
        return j, t

    (js, _, jb), (ts, _, tb) = with_settle(stacks, go())
    assert js == ts == 200
    assert_close(tb, jb)
    if body.get("stream"):
        assert jb[-1] == "[DONE]" and jb[-2]["usage"]["completion_tokens"] == body["max_tokens"]
    else:
        assert jb["usage"]["completion_tokens"] == body["max_tokens"]


@pytest.mark.parametrize("stream", [False, True])
def test_stop_strings_equal_the_jax_service(stacks, stream):
    """A stop string cut out of the greedy text itself: both services stop
    at it, drop it from the text and finish with reason stop."""

    async def go():
        probe = completion("stop string probe", max_tokens=24, temperature=0, seed=4,
                           ignore_eos=True)
        _, _, full = await call(stacks["jax"].base, "/v1/completions", probe, False)
        text = full["choices"][0]["text"]
        stop = next(text[i:i + 2] for i in range(6, len(text) - 1)
                    if text[i:i + 2].strip() and "�" not in text[i:i + 2])
        body = dict(probe, stop=[stop], stream=stream)
        j = await call(stacks["jax"].base, "/v1/completions", body, stream)
        t = await call(stacks["port"].base, "/v1/completions", body, stream)
        return stop, j, t

    stop, (js, _, jb), (ts, _, tb) = with_settle(stacks, go())
    assert js == ts == 200
    assert_close(tb, jb)
    final = jb[-2] if stream else jb
    assert final["choices"][0]["finish_reason"] == "stop"
    if not stream:
        assert stop not in jb["choices"][0]["text"]


ERRORS = {
    "unknown_model": ("/v1/chat/completions", chat("x", model="nope"), None, None, 404),
    "bad_json": ("/v1/chat/completions", None, b"{not json", None, 400),
    "missing_messages": ("/v1/chat/completions", {"model": MODEL}, None, None, 400),
    "bad_timeout_header": ("/v1/completions", completion("x", max_tokens=2), None,
                           {"X-Request-Timeout": "-3"}, 400),
    "deadline": ("/v1/completions", completion("slow " * 20, max_tokens=240, ignore_eos=True,
                                               temperature=0, seed=1), None,
                 {"X-Request-Timeout": "0.05"}, 504),
    "embeddings": ("/v1/embeddings", {"model": MODEL, "input": "embed me"}, None, None, 501),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_paths_match_the_jax_service(stacks, name):
    path, body, raw, headers, want = ERRORS[name]

    async def go():
        out = []
        for side in ("jax", "port"):
            out.append(await call(stacks[side].base, path, body, False, headers=headers,
                                  raw_body=raw))
        return out

    (js, _, jb), (ts, _, tb) = stacks["run"](go())
    assert js == ts == want, (jb, tb)
    assert tb["error"]["type"] == jb["error"]["type"]
    assert tb["error"]["code"] == jb["error"]["code"]


def test_response_format_is_refused_with_a_typed_400(stacks):
    """A response_format the grammar compiler cannot express (an unknown
    schema type) is refused up front by both services' preprocessors,
    before any engine work, with the same typed 400 and message."""
    rf = {"type": "json_schema", "json_schema": {"name": "x", "schema": {"type": "zzz"}}}
    body = chat("json please", response_format=rf, max_tokens=4)

    async def go():
        return [await call(stacks[side].base, "/v1/chat/completions", body, False)
                for side in ("jax", "port")]

    (js, _, jb), (ts, _, tb) = stacks["run"](go())
    assert js == ts == 400 and tb["error"]["type"] == "invalid_request_error"
    assert "response_format" in tb["error"]["message"]
    assert tb["error"] == jb["error"]


@pytest.mark.parametrize("case", ["max_inflight_429", "draining_503"])
def test_admission_sheds_as_the_jax_service(stacks, case):
    """A second frontend per stack on the same store: with max_inflight 1
    a concurrent second request is shed with 429 + Retry-After; a draining
    frontend sheds with 503 + Retry-After."""

    async def one(side):
        pkg, url = stacks[side].pkg, stacks[side].store.url
        adm = mod(pkg, "runtime.admission").AdmissionController(
            max_inflight=1, max_queue_depth=0, retry_after=2.0)
        fe = await start_frontend(pkg, url, admission=adm)
        try:
            await wait_for_models(fe.base, [MODEL])
            if case == "draining_503":
                fe.http.start_draining()
                return await call(fe.base, "/v1/chat/completions", chat("x", max_tokens=2), False)
            slow = asyncio.ensure_future(call(
                fe.base, "/v1/completions", completion("hold the slot", max_tokens=120,
                                                       ignore_eos=True, seed=1), False))
            while adm.inflight == 0:
                await asyncio.sleep(0.005)
            shed = await call(fe.base, "/v1/completions", completion("x", max_tokens=2), False)
            assert (await slow)[0] == 200
            return shed
        finally:
            await stop_frontend(fe)

    async def go():
        return await one("jax"), await one("port")

    (js, jh, jb), (ts, th, tb) = stacks["run"](go())
    want = 503 if case == "draining_503" else 429
    assert js == ts == want
    assert tb["error"]["type"] == jb["error"]["type"] == "overloaded_error"
    assert th["retry-after"] == jh["retry-after"]


def test_client_disconnect_frees_the_engine_row(stacks):
    """The client drops a long stream after two chunks: the port's frontend
    notices at its next write, cancels the request across the wire, and the
    engine frees the row long before max_tokens."""
    port = stacks["port"]

    async def go():
        before = port.engine.total_generated
        body = completion("disconnect me " * 4, max_tokens=240, ignore_eos=True, seed=9,
                          temperature=0, stream=True)
        async with httpx.AsyncClient(timeout=30) as c:
            async with c.stream("POST", f"{port.base}/v1/completions", json=body) as r:
                assert r.status_code == 200
                n = 0
                async for _chunk in r.aiter_bytes():
                    n += 1
                    if n == 2:
                        break
        for _ in range(500):
            if not port.engine.busy():
                break
            await asyncio.sleep(0.01)
        return port.engine.busy(), port.engine.total_generated - before

    busy, generated = stacks["run"](go())
    assert not busy
    assert 0 < generated < 240


# -- the server core on its own --------------------------------------------------


def _core_app(events: list):
    from dynamo_tpu_torch.runtime import http_server as web

    async def echo(request):
        return web.json_response({"path": request.path, "id": request.match_info.get("id"),
                                  "q": request.query.get("q"), "body": await request.json(),
                                  "ua": request.headers.get("USER-AGENT")})

    async def stream(request):
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        try:
            for i in range(200):
                await resp.write(f"data: {i}\n\n".encode())
                await asyncio.sleep(0.005)
        except ConnectionResetError:
            events.append("reset")
            return resp
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_post("/echo/{id}", echo)
    app.router.add_get("/stream", stream)
    return app


async def _raw(port: int, data: bytes, read_until: bytes | None = None) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = b""
    try:
        async with asyncio.timeout(10):
            while read_until is None or read_until not in out:
                piece = await reader.read(65536)
                if not piece:
                    break
                out += piece
    finally:
        writer.close()
    return out


def test_server_core_protocol():
    """Keep-alive, path parameters, query, case-insensitive headers,
    Expect: 100-continue, 404 / 405 / 501, chunked SSE on HTTP/1.1 and a
    close-delimited body on HTTP/1.0."""
    from dynamo_tpu_torch.runtime import http_server as web

    async def go():
        runner = web.AppRunner(_core_app([]))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            body = json.dumps({"x": 1}).encode()
            one = (b"POST /echo/a%%20b?q=z HTTP/1.1\r\nHost: h\r\nuser-agent: t\r\n"
                   b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            two = (b"POST /echo/7 HTTP/1.1\r\nExpect: 100-continue\r\nConnection: close\r\n"
                   b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            out = await _raw(port, one + two)
            assert out.count(b"HTTP/1.1 200 OK") == 2 and b"HTTP/1.1 100 Continue" in out
            first = json.loads(out.split(b"\r\n\r\n", 2)[1].split(b"HTTP/1.1")[0])
            assert first == {"path": "/echo/a b", "id": "a b", "q": "z", "body": {"x": 1},
                             "ua": "t"}
            assert b"Connection: close" in out
            assert b"404 Not Found" in await _raw(
                port, b"GET /nope HTTP/1.1\r\nConnection: close\r\n\r\n")
            assert b"405 Method Not Allowed" in await _raw(
                port, b"GET /echo/1 HTTP/1.1\r\nConnection: close\r\n\r\n")
            assert b"501 Not Implemented" in await _raw(
                port, b"POST /echo/1 HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n0\r\n\r\n")
            assert b"400 Bad Request" in await _raw(port, b"garbage\r\n\r\n")
            sse = await _raw(port, b"GET /stream HTTP/1.1\r\n\r\n", read_until=b"0\r\n\r\n")
            assert b"Transfer-Encoding: chunked" in sse and b"data: 199" in sse
            old = await _raw(port, b"GET /stream HTTP/1.0\r\n\r\n")
            assert b"Transfer-Encoding" not in old and old.endswith(b"data: 199\n\n")
        finally:
            await runner.cleanup()

    asyncio.run(go())


def test_server_core_write_raises_after_the_client_leaves():
    from dynamo_tpu_torch.runtime import http_server as web

    events: list = []

    async def go():
        runner = web.AppRunner(_core_app(events))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /stream HTTP/1.1\r\n\r\n")
            await reader.readuntil(b"data: 3")
            writer.close()
            for _ in range(400):
                if events:
                    break
                await asyncio.sleep(0.005)
        finally:
            await runner.cleanup()

    asyncio.run(go())
    assert events == ["reset"]


def test_server_core_answers_a_half_closed_client():
    """A client that sends its request and then shuts down its write side
    (HTTP/1.0 style, ``nc -N``) still gets the whole response: a fixed
    body and a chunked stream."""
    from dynamo_tpu_torch.runtime import http_server as web

    events: list = []

    async def half_closed(port: int, data: bytes) -> bytes:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(data)
        writer.write_eof()
        try:
            async with asyncio.timeout(10):
                return await reader.read()
        finally:
            writer.close()

    async def go():
        runner = web.AppRunner(_core_app(events))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            body = json.dumps({"x": 2}).encode()
            out = await half_closed(port, b"POST /echo/h HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
                                    % (len(body), body))
            assert out.startswith(b"HTTP/1.1 200 OK")
            assert json.loads(out.split(b"\r\n\r\n", 1)[1])["body"] == {"x": 2}
            sse = await half_closed(port, b"GET /stream HTTP/1.1\r\n\r\n")
            assert b"data: 199\n\n" in sse and sse.endswith(b"0\r\n\r\n")
        finally:
            await runner.cleanup()

    asyncio.run(go())
    assert events == []
