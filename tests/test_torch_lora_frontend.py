"""tests/test_lora_frontend.py's two cases with port workers (CPU).

Each worker is a port ``TorchEngine`` (test-tiny, float32, a bank of two
slots with "tenant-a" and "tenant-b" registered) serving the base model
card and one card per adapter (the worker CLI's ``adapter_cards``) behind
the port's frontend (``ModelWatcher``, ``ModelManager``, ``HttpService``):

- /v1/models lists the base model and both adapters, with the JAX
  package's lora metadata; an unknown adapter name is a typed 404 at the
  frontend; a registered adapter's request reaches the worker with its
  adapter_id stamped by the preprocessor, and its greedy completion
  differs from the base model's;
- two frontends sharing a decision cache (the JAX package's: the fleet
  modules are not ported yet) keep an adapter conversation on its warm
  engine, each turn waiting until both frontends see the last turn's
  decision, and the same token stream under another adapter finds no
  cached placement (the cache is keyed by adapter-salted hashes).
"""

from __future__ import annotations

import asyncio

import httpx
import numpy as np
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.fleet.decisions import RouterDecisionCache
from dynamo_tpu.runtime.store import connect_store as jax_store
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster, serve_kv_endpoints
from dynamo_tpu_torch.kv_router.router import KvRouterConfig
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_model
from dynamo_tpu_torch.llm.pipeline import RouterSettings
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.tokens import adapter_hash_seed, compute_block_hashes
from dynamo_tpu_torch.worker.__main__ import adapter_cards

ADAPTERS = [("tenant-a", 4, 7), ("tenant-b", 4, 9)]
PARAMS = None


def base_card() -> ModelDeploymentCard:
    return ModelDeploymentCard(name="test-tiny", kv_cache_block_size=4,
                               eos_token_ids=[ByteTokenizer.EOS], context_length=256)


async def start_worker(store_url, namespace="lf"):
    global PARAMS
    if PARAMS is None:
        PARAMS = jax.tree.map(np.asarray,
                              JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))
    rt = await DistributedRuntime.create(store_url=store_url)
    engine = TorchEngine(EngineArgs(
        model=ModelConfig(), device="cpu", dtype="float32", block_size=4, num_kv_blocks=256,
        max_num_seqs=4, max_model_len=256, decode_steps=4, lora_slots=2, lora_rank=4),
        params=params_from_numpy(PARAMS, "cpu", torch.float32))
    for name, rank, seed in ADAPTERS:
        engine.register_adapter(name, rank=rank, seed=seed)
    await engine.start()
    broadcaster = KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)
    comp = rt.namespace(namespace).component("backend")
    # The worker records each request's adapter_id, so the test sees the
    # preprocessor's stamp end to end.
    seen: list = []

    async def gen_handler(payload, ctx):
        seen.append((payload or {}).get("adapter_id"))
        async for item in engine.generate(payload, ctx):
            yield item

    await comp.endpoint("generate").serve(gen_handler)
    await serve_kv_endpoints(comp, broadcaster, engine.metrics)
    card = base_card()
    await register_model(rt, namespace, card)
    for acard in adapter_cards(card, ADAPTERS):
        await register_model(rt, namespace, acard)
    return rt, engine, seen


async def stop_worker(w):
    await w[0].shutdown()
    await w[1].stop()


async def start_frontend(store_url, namespace="lf", fleet_id="lftest"):
    rt = await DistributedRuntime.create(store_url=store_url)
    # The fleet decision cache is not ported yet (ROADMAP A19): the JAX
    # package's, on a JAX store of its own, shared by every frontend here
    # (it compares the JAX store's event kinds).
    cache = await RouterDecisionCache(await jax_store(store_url + "-decisions"), fleet_id,
                                      ttl=60.0).start()
    settings = RouterSettings(mode=RouterMode.KV, kv=KvRouterConfig(use_kv_events=False),
                              decisions=cache)
    manager = ModelManager(rt, settings)
    watcher = await ModelWatcher(rt, manager, namespace).start()
    http = await HttpService(manager, rt.metrics, health=rt.health, host="127.0.0.1",
                             port=0).start()
    for _ in range(100):
        if len(manager.list_names()) >= 3:
            break
        await asyncio.sleep(0.05)
    return rt, manager, watcher, http, cache


async def stop_frontend(f):
    await f[3].close()
    await f[2].close()
    await f[1].close()
    await f[0].shutdown()


def test_models_list_and_unknown_adapter_404():
    async def go():
        url = "memory://torch_lora_frontend_models"
        w = await start_worker(url)
        f = await start_frontend(url)
        try:
            async with httpx.AsyncClient(timeout=60) as client:
                base = f"http://127.0.0.1:{f[3].port}"
                r = await client.get(f"{base}/v1/models")
                assert r.status_code == 200
                entries = {e["id"]: e for e in r.json()["data"]}
                assert set(entries) == {"test-tiny", "tenant-a", "tenant-b"}
                assert "lora" not in entries["test-tiny"]
                assert entries["tenant-a"]["lora"] == {
                    "adapter_id": "tenant-a", "base": "test-tiny", "rank": 4,
                    "resident_tier": "G2"}
                r = await client.post(f"{base}/v1/completions", json={
                    "model": "tenant-zz", "prompt": "hi", "max_tokens": 4})
                assert r.status_code == 404
                assert r.json()["error"]["type"] == "not_found_error"
                texts = {}
                for model in ("tenant-a", "test-tiny"):
                    r = await client.post(f"{base}/v1/completions", json={
                        "model": model, "prompt": "hello there", "max_tokens": 12,
                        "ignore_eos": True, "seed": 1, "temperature": 0,
                        "logprobs": 0})
                    assert r.status_code == 200, r.text
                    texts[model] = r.json()["choices"][0]["logprobs"]["token_logprobs"]
                assert w[2] == ["tenant-a", None]
                assert texts["tenant-a"] != texts["test-tiny"]
                assert w[1].lora_stats()["pageins"] == 1
        finally:
            await stop_frontend(f)
            await stop_worker(w)

    asyncio.run(go())


def test_adapter_conversation_sticks_across_frontends():
    """Two frontends, two engines, no KV events: only the shared decision
    cache (keyed by adapter-salted hashes) keeps an adapter conversation
    on its warm engine, and another adapter's identical prompt finds no
    placement."""

    async def go():
        url = "memory://torch_lora_frontend_sticky"
        w1 = await start_worker(url)
        w2 = await start_worker(url)
        f1 = await start_frontend(url)
        f2 = await start_frontend(url)
        bases = [f"http://127.0.0.1:{f[3].port}" for f in (f1, f2)]
        try:
            async with httpx.AsyncClient(timeout=60) as client:
                async def turn(base: str, model: str, prompt: str) -> str:
                    r = await client.post(f"{base}/v1/completions", json={
                        "model": model, "prompt": prompt, "max_tokens": 4,
                        "ignore_eos": True, "seed": 0})
                    assert r.status_code == 200, r.text
                    return r.json()["choices"][0]["text"]

                async def settled(prompt: str, depth: int) -> int:
                    """Wait until both frontends' caches hold this turn's
                    decision (deeper than ``depth`` blocks) → its depth:
                    the write and its mirror echo are asynchronous."""
                    hashes = compute_block_hashes(ByteTokenizer().encode(prompt), 4,
                                                  adapter_hash_seed("tenant-a"))
                    for _ in range(800):
                        hits = [f[4].scoped(scope).lookup(hashes) for f in (f1, f2)]
                        if all(h is not None and h[1] > depth for h in hits):
                            return min(h[1] for h in hits)
                        await asyncio.sleep(0.025)
                    raise AssertionError(f"no shared decision for the turn: {hits}")

                scope = adapter_cards(base_card(), ADAPTERS)[0].slug  # the router's key
                e1, e2 = w1[1], w2[1]
                prompt = "adapter conversation seed " * 4
                await turn(bases[0], "tenant-a", prompt)
                warm = e1 if e1.total_generated > 0 else e2
                cold = e2 if warm is e1 else e1
                assert warm.total_generated > 0 and cold.total_generated == 0
                depth = await settled(prompt, 0)
                for i in range(4):
                    prompt = prompt + f" turn {i} extends the history"
                    await turn(bases[i % 2], "tenant-a", prompt)
                    depth = await settled(prompt, depth)
                assert cold.total_generated == 0, "the conversation leaked to the cold engine"
                ids = ByteTokenizer().encode(prompt)
                assert f2[4].scoped(scope).lookup(compute_block_hashes(
                    ids, 4, adapter_hash_seed("tenant-a"))) is not None
                assert f2[4].scoped("tenant-b").lookup(compute_block_hashes(
                    ids, 4, adapter_hash_seed("tenant-b"))) is None
        finally:
            for f in (f1, f2):
                await stop_frontend(f)
            for w in (w1, w2):
                await stop_worker(w)

    asyncio.run(go())
