"""The port's OpenAI client (asyncio streams) against the JAX package's
(httpx), both driving one port frontend in this process.

The frontend serves a port mocker worker over an in-memory store, so every
answer is deterministic: each typed surface (chat, completion, responses,
models, health, clear_kv_blocks, chat_stream) must return the same body
from both clients once the per-response ids and timestamps are set aside;
embeddings (the mocker serves none), an unknown model, a malformed body, a
path the server does not route (a body that is not JSON: ``_safe_json``
returns its text) and a model with no worker (503, retried) must raise
``OpenAIClientError`` with the same status and body; and a streamed
request refused before its first chunk must raise the same error too.
"""

from __future__ import annotations

import asyncio

import pytest

from dynamo_tpu.llm.client import OpenAIClient as JClient
from dynamo_tpu.llm.client import OpenAIClientError as JError
from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster, serve_kv_endpoints
from dynamo_tpu_torch.llm.client import OpenAIClient as TClient
from dynamo_tpu_torch.llm.client import OpenAIClientError as TError
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_model
from dynamo_tpu_torch.llm.pipeline import RouterSettings
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.mocker import MockerArgs, MockerEngine
from dynamo_tpu_torch.runtime.config import Config
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.push_router import RouterMode

VOLATILE = {"id", "created", "created_at", "system_fingerprint"}
CHAT = [{"role": "user", "content": "hello client"}]


def scrub(x):
    """A response with its ids and timestamps set aside."""
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    return x


async def serve(name: str):
    """A port mocker worker and the port frontend on one in-memory store →
    (frontend base URL, closer)."""
    url = f"memory://torch_client_{name}"
    cfg = Config.from_env({})
    cfg.runtime.retry_backoff_base = 0.005  # the 503 of a model with no worker comes fast
    cfg.runtime.retry_backoff_max = 0.05
    wrt = await DistributedRuntime.create(store_url=url, config=cfg)
    engine = MockerEngine(MockerArgs(block_size=4, num_kv_blocks=256, speedup=1e6,
                                     delta_max_tokens=0))
    broadcaster = KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)
    comp = wrt.namespace("cli").component("backend")

    async def gen(payload, ctx):
        async for item in engine.generate(payload, ctx):
            yield item

    await comp.endpoint("generate").serve(gen)
    await serve_kv_endpoints(comp, broadcaster, engine.metrics)
    await register_model(wrt, "cli", ModelDeploymentCard(
        name="mock-model", kv_cache_block_size=4, eos_token_ids=[ByteTokenizer.EOS],
        context_length=256))
    # A second model whose component no worker serves: a 503 at request time.
    await register_model(wrt, "cli", ModelDeploymentCard(
        name="ghost", kv_cache_block_size=4, eos_token_ids=[ByteTokenizer.EOS],
        context_length=256, component="nobody"))
    frt = await DistributedRuntime.create(store_url=url, config=cfg)
    manager = ModelManager(frt, RouterSettings(mode=RouterMode.ROUND_ROBIN))
    watcher = await ModelWatcher(frt, manager).start()
    http = await HttpService(manager, frt.metrics, health=frt.health, host="127.0.0.1",
                             port=0).start()

    async def close():
        await http.close()
        await watcher.close()
        await manager.close()
        await frt.shutdown()
        await wrt.shutdown()
        await wrt.store.close()

    return f"http://127.0.0.1:{http.port}", close


async def calls(client) -> dict:
    """Every typed surface once → {name: scrubbed result or (status, body)}."""
    for _ in range(200):
        if sorted(await client.models()) == ["ghost", "mock-model"]:
            break
        await asyncio.sleep(0.02)
    out = {}
    surfaces = {
        "models": lambda: client.models(),
        "health": lambda: client.health(),
        "chat": lambda: client.chat(CHAT, max_tokens=6, logprobs=True, top_logprobs=2),
        "completion": lambda: client.completion("hello completion", max_tokens=5),
        "responses": lambda: client.responses("hello responses", max_output_tokens=4),
        "clear_kv_blocks": lambda: client.clear_kv_blocks(),
        "embeddings": lambda: client.embeddings("embed me"),
        "unknown_model": lambda: client.chat(CHAT, model="nope", max_tokens=2),
        "bad_body": lambda: client.completion(None, max_tokens=2),
        "no_worker": lambda: client.chat(CHAT, model="ghost", max_tokens=2),
    }
    for name, fn in surfaces.items():
        try:
            res = await fn()
            out[name] = sorted(res) if name == "models" else scrub(res)
        except (JError, TError) as e:
            out[name] = ("error", e.status, scrub(e.body))
    out["stream"] = [scrub(ch) async for ch in client.chat_stream(CHAT, max_tokens=7)]
    try:
        out["stream_refused"] = [ch async for ch in client.chat_stream(CHAT, model="nope")]
    except (JError, TError) as e:
        out["stream_refused"] = ("error", e.status, scrub(e.body))
    return out


def test_both_clients_see_the_same_frontend():
    async def go():
        base, close = await serve("same")
        try:
            async with JClient(base, default_model="mock-model", max_retries=1,
                               backoff_s=0.01) as jc:
                jax_out = await calls(jc)
            async with TClient(base, default_model="mock-model", max_retries=1,
                               backoff_s=0.01) as tc:
                port_out = await calls(tc)
            # A path the server does not route: a text body, not JSON.
            errs = []
            for cls, err in ((JClient, JError), (TClient, TError)):
                async with cls(base + "/nowhere", max_retries=0) as c:
                    with pytest.raises(err) as ei:
                        await c.models()
                    errs.append((ei.value.status, ei.value.body))
            return jax_out, port_out, errs
        finally:
            await close()

    jax_out, port_out, errs = asyncio.run(asyncio.wait_for(go(), 60))
    assert port_out == jax_out
    # The mocker echoes the prompt: the chat's rendered template, the
    # completion's text.
    assert port_out["chat"]["usage"]["completion_tokens"] == 6
    assert port_out["completion"]["choices"][0]["text"] == "hello"
    assert port_out["chat"]["choices"][0]["logprobs"]["content"]
    assert len(port_out["stream"]) > 2
    for name in ("embeddings", "unknown_model", "bad_body", "no_worker", "stream_refused"):
        assert port_out[name][0] == "error", (name, port_out[name])
    assert port_out["unknown_model"][1] == 404 and port_out["no_worker"][1] == 503
    assert port_out["bad_body"][1] == 400
    assert errs[0] == errs[1] and errs[1][0] == 404 and isinstance(errs[1][1], str)


def test_port_client_needs_its_context_and_an_http_url():
    with pytest.raises(ValueError):
        TClient("https://127.0.0.1:1")

    async def go():
        c = TClient("http://127.0.0.1:1")
        with pytest.raises(ValueError):
            await c.models()

    asyncio.run(go())


def test_transport_errors_retry_then_surface():
    """Nothing listens: both clients retry, then raise a transport error."""
    import socket

    import httpx

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def go():
        async with JClient(f"http://127.0.0.1:{port}", max_retries=2, backoff_s=0.01) as c:
            with pytest.raises((httpx.TransportError, OSError)):
                await c.chat(CHAT)
        async with TClient(f"http://127.0.0.1:{port}", max_retries=2, backoff_s=0.01) as c:
            with pytest.raises(OSError):
                await c.chat(CHAT)
            with pytest.raises(OSError):
                [ch async for ch in c.chat_stream(CHAT)]

    asyncio.run(asyncio.wait_for(go(), 30))
