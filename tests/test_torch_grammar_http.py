"""Structured output and embeddings over the port's HTTP stack, on the CPU.

One TCP store; a JAX worker runtime (``TpuEngine``, XLA attention) and a
port worker runtime (``TorchEngine``) on the same numpy weights (test-tiny,
float32), each serving ``generate`` and ``embed`` as the worker CLIs wire
them, under two model names on two components; the JAX frontend and the
port frontend each serve both models. Every request goes through all four
(frontend, worker) pairs and must equal the all-JAX pair:

- chat with a bounded ``json_schema`` response_format, greedy and seeded
  sampled, aggregate (whole bodies, ids dropped, logprob values to 1e-4)
  and streamed (the concatenated text, finish reason and usage: a
  stream's framing follows host timing). ``/v1/completions`` carries no
  response_format in the JAX package's protocol (its CompletionRequest
  has no such field), so a completion with one is served unconstrained
  there, and by the port the same way: compared, not validated;
- ``/v1/responses`` with ``text.format`` and a ``json_object`` chat;
- bounded schemas parse and validate, finishing ``stop``;
- an unknown schema type: the same typed 400 from both frontends;
- ``/v1/embeddings`` with several inputs: 200 and vectors within 1e-5
  of the JAX stack's (tests/test_torch_embed.py's float32 tolerance);
  an over-long input gets the same 400.

Not copied: tests/test_frontend_grammar.py's
``test_chat_response_format_returns_schema_valid_json`` expectation, which
the random-weight model fails on the JAX package itself (an unbounded
string that never closes); here every schema is bounded.
"""

from __future__ import annotations

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_http import (
    assert_close,
    call,
    jax_engine,
    mod,
    np_weights,
    port_engine,
    start_frontend,
    start_store,
    stop_frontend,
    stop_runtime,
    wait_for_models,
)

SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8},
    "age": {"type": "integer"},
    "active": {"type": "boolean"},
    "kind": {"enum": ["cat", "dog"]},
}}
RF = {"type": "json_schema", "json_schema": {"name": "rec", "schema": SCHEMA}}
PAIRS = (("jax/jax", "jax", "jw"), ("jax/port", "jax", "tw"), ("port/jax", "port", "jw"),
         ("port/port", "port", "tw"))


async def start_worker(pkg: str, store_url: str, engine, name: str, component: str):
    """A worker runtime as the worker CLIs wire it: generate, embed, the KV
    endpoints, and a model card naming its component."""
    rt = await mod(pkg, "runtime.distributed").DistributedRuntime.create(store_url=store_url)
    pub, mc = mod(pkg, "kv_router.publisher"), mod(pkg, "llm.model_card")
    broadcaster = pub.KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)
    comp = rt.namespace("dynamo").component(component)

    async def gen_handler(payload, ctx):
        async for item in engine.generate(payload, ctx):
            yield item

    async def embed_handler(payload, ctx):
        try:
            yield {"embedding": await engine.embed((payload or {}).get("token_ids") or [])}
        except Exception as e:  # noqa: BLE001 — per-request failure, as the worker CLIs
            yield {"error": str(e)}

    await comp.endpoint("generate").serve(gen_handler)
    await comp.endpoint("embed").serve(embed_handler)
    await pub.serve_kv_endpoints(comp, broadcaster, engine.metrics)
    card = mc.ModelDeploymentCard(name=name, kv_cache_block_size=4, eos_token_ids=[257],
                                  context_length=256, component=component)
    await mc.register_model(rt, "dynamo", card)
    return rt


@pytest.fixture(scope="module")
def mixed():
    loop = asyncio.new_event_loop()
    params = np_weights()

    async def build():
        store = await start_store("dynamo_tpu")
        jeng = await jax_engine(params).start()
        teng = await port_engine(params).start()
        jw = await start_worker("dynamo_tpu", store.url, jeng, "jw", "jbackend")
        tw = await start_worker("dynamo_tpu_torch", store.url, teng, "tw", "tbackend")
        fes = {"jax": await start_frontend("dynamo_tpu", store.url),
               "port": await start_frontend("dynamo_tpu_torch", store.url)}
        for fe in fes.values():
            await wait_for_models(fe.base, ["jw", "tw"])
        return SimpleNamespace(store=store, engines=(jeng, teng), workers=(jw, tw), fes=fes)

    s = loop.run_until_complete(build())
    s.run = loop.run_until_complete
    yield s

    async def teardown():
        for fe in s.fes.values():
            await stop_frontend(fe)
        for w in s.workers:
            await stop_runtime(w)
        for e in s.engines:
            await e.stop()
        await s.store.close()

    loop.run_until_complete(teardown())
    loop.close()


def through_all(mixed, path, body, stream=False):
    """→ {pair label: (status, body)} for the four (frontend, worker) pairs,
    one request at a time."""

    async def go():
        out = {}
        for label, fe, model in PAIRS:
            st, _, res = await call(mixed.fes[fe].base, path, dict(body, model=model), stream)
            res = json.loads(json.dumps(res).replace('"tw"', '"jw"'))
            if isinstance(res, dict):
                res.pop("created_at", None)  # a clock reading, as "created"
            out[label] = (st, res)
        return out

    return mixed.run(go())


def assert_valid(content: str) -> None:
    obj = json.loads(content)
    assert set(obj) == set(SCHEMA["properties"])
    assert isinstance(obj["name"], str) and len(obj["name"]) <= 8
    assert isinstance(obj["age"], int) and not isinstance(obj["age"], bool)
    assert isinstance(obj["active"], bool) and obj["kind"] in ("cat", "dog")


def chat(content, **kw):
    return {"messages": [{"role": "user", "content": content}], **kw}


AGGREGATE = {
    "chat_schema_greedy": ("/v1/chat/completions", chat(
        "Give me a record.", response_format=RF, max_tokens=128, temperature=0, seed=1,
        logprobs=True, top_logprobs=2)),
    "chat_schema_sampled": ("/v1/chat/completions", chat(
        "Another record, please.", response_format=RF, max_tokens=128, temperature=0.8,
        seed=7, logprobs=True)),
    "completion_schema": ("/v1/completions", {
        "prompt": "record:", "response_format": RF, "max_tokens": 128, "temperature": 0,
        "seed": 3, "logprobs": 1}),
    "chat_json_object": ("/v1/chat/completions", chat(
        "json please", response_format={"type": "json_object"}, max_tokens=40,
        temperature=0, seed=2)),
    "responses_text_format": ("/v1/responses", {
        "input": "A record as JSON.", "max_output_tokens": 128, "temperature": 0, "seed": 5,
        "text": {"format": {"type": "json_schema", "name": "rec", "schema": SCHEMA}}}),
}


def _content(path: str, body: dict) -> tuple[str, str | None]:
    if path == "/v1/chat/completions":
        ch = body["choices"][0]
        return ch["message"]["content"], ch["finish_reason"]
    if path == "/v1/completions":
        ch = body["choices"][0]
        return ch["text"], ch["finish_reason"]
    texts = [c["text"] for item in body["output"] for c in item.get("content", [])
             if c.get("type") == "output_text"]
    return "".join(texts), body.get("status")


@pytest.mark.parametrize("name", sorted(AGGREGATE))
def test_structured_aggregate_equals_the_all_jax_stack(mixed, name):
    path, body = AGGREGATE[name]
    out = through_all(mixed, path, body)
    ref_status, ref = out.pop("jax/jax")
    assert ref_status == 200, ref
    for label, (st, res) in out.items():
        assert st == 200, (label, res)
        assert_close(res, ref)
    content, finish = _content(path, ref)
    if name not in ("chat_json_object", "completion_schema"):
        assert finish in ("stop", "completed"), (finish, content)
        assert_valid(content)


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/completions"])
def test_structured_stream_equals_the_all_jax_stack(mixed, path):
    body = (chat("Stream a record.", response_format=RF, max_tokens=128, temperature=0, seed=4,
                 stream=True) if path == "/v1/chat/completions" else
            {"prompt": "streamed record:", "response_format": RF, "max_tokens": 128,
             "temperature": 0, "seed": 6, "stream": True})
    out = through_all(mixed, path, body, stream=True)

    def view(events):
        assert events[-1] == "[DONE]"
        chunks = [e for e in events[:-1] if e.get("choices")]
        key = "delta" if path == "/v1/chat/completions" else None
        text = "".join((c["choices"][0][key].get("content") or "") if key
                       else (c["choices"][0].get("text") or "") for c in chunks)
        finish = [c["choices"][0]["finish_reason"] for c in chunks
                  if c["choices"][0].get("finish_reason")]
        usage = [e["usage"] for e in events[:-1] if e.get("usage")]
        return text, finish, usage

    ref_status, ref = out.pop("jax/jax")
    assert ref_status == 200
    want = view(ref)
    if path == "/v1/chat/completions":
        assert want[1] == ["stop"]
        assert_valid(want[0])
    for label, (st, res) in out.items():
        assert st == 200 and view(res) == want, label


def test_unsupported_schema_gets_the_jax_frontends_400(mixed):
    body = chat("x", response_format={"type": "json_schema", "json_schema": {
        "name": "bad", "schema": {"type": "object", "properties": {"a": {"type": "zzz"}}}}},
        max_tokens=8)
    out = through_all(mixed, "/v1/chat/completions", body)
    ref_status, ref = out.pop("jax/jax")
    assert ref_status == 400 and ref["error"]["type"] == "invalid_request_error"
    for label, (st, res) in out.items():
        assert st == 400 and res["error"] == ref["error"], label


def test_embeddings_equal_the_all_jax_stack(mixed):
    body = {"input": ["embed me", "a second, somewhat longer input to embed " * 3,
                      list(range(1, 40))]}
    out = through_all(mixed, "/v1/embeddings", body)
    ref_status, ref = out.pop("jax/jax")
    assert ref_status == 200 and len(ref["data"]) == 3
    for label, (st, res) in out.items():
        assert st == 200, (label, res)
        assert res["usage"] == ref["usage"] and res["model"] == ref["model"]
        for a, b in zip(res["data"], ref["data"]):
            assert a["index"] == b["index"] and len(a["embedding"]) == 128
            np.testing.assert_allclose(a["embedding"], b["embedding"], atol=1e-5, rtol=1e-5)
    over = through_all(mixed, "/v1/embeddings", {"input": list(range(1, 300))})
    ref_status, ref = over.pop("jax/jax")
    assert ref_status == 400
    for label, (st, res) in over.items():
        assert st == 400 and res["error"] == ref["error"], label
