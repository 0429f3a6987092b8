"""Cross-worker KV prefix reuse in the port (``llm/peer_kv.py``), on the CPU.

Mirrors tests/test_peer_kv.py with port workers: real ``TorchEngine``s with
a G2 host tier behind the port's runtime, each serving ``generate``
wrapped in ``PeerPrefixFetcher`` and the ``kv_prefix`` endpoint. Worker A
prefills a prompt (write-through offload puts its blocks in A's G2), and
worker B serves the same prefix from a ``peer_prefix`` hint: pages fetched
from A and injected as a prefix hit, so B computes only the suffix and
emits A's tokens. Also the delta fetch past B's own blocks, no fetch when
B's own coverage suffices, the KV router's hint to a cold worker, the
worker CLIs spawned with ``--device cpu --host-kv-blocks``, and mixed
stacks on one TCP store: a port worker fetching from a JAX worker's tiers,
and the reverse (same weights, test-tiny in float32).
"""

from __future__ import annotations

import asyncio
import importlib
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
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.tokens import compute_block_hashes
from procutil import ManagedProcess

BS = 4
ENGINE = dict(block_size=BS, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
              dtype="float32", decode_steps=2, host_kv_blocks=32)
PROMPT = [7 * i % 500 + 1 for i in range(23)]  # 5 matchable blocks + suffix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def make_engine(pkg: str, np_params):
    if pkg == "dynamo_tpu":
        return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **ENGINE), params=np_params)
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **ENGINE),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


async def start_worker(store_url: str, np_params, pkg: str = "dynamo_tpu_torch",
                       namespace: str = "peerkv"):
    """A real engine with a host tier on ``pkg``'s runtime, serving
    generate (peer-fetch wrapped), kv_prefix and the KV event and metrics
    endpoints. → (runtime, engine, fetcher, instance id)."""
    rt = await mod(pkg, "runtime.distributed").DistributedRuntime.create(store_url=store_url)
    engine = await make_engine(pkg, np_params).start()
    pub = mod(pkg, "kv_router.publisher")
    peer = mod(pkg, "llm.peer_kv")
    broadcaster = pub.KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)
    comp = rt.namespace(namespace).component("backend")
    fetcher = peer.PeerPrefixFetcher(engine, await comp.endpoint(peer.KV_PREFIX_ENDPOINT).router(
        mod(pkg, "runtime.push_router").RouterMode.DIRECT))

    async def gen_handler(payload, ctx):
        async for item in fetcher.generate(payload, ctx):
            yield item

    await comp.endpoint("generate").serve(gen_handler)
    await comp.endpoint(peer.KV_PREFIX_ENDPOINT).serve(peer.make_kv_prefix_handler(engine))
    await pub.serve_kv_endpoints(comp, broadcaster, engine.metrics)
    return rt, engine, fetcher, await rt.primary_lease()


def make_request(prompt=PROMPT, max_tokens=8, **ktp) -> dict:
    d = {"model": "tiny", "token_ids": list(prompt),
         "sampling": {"temperature": 0.0, "seed": 0},
         "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
    if ktp:
        d["kv_transfer_params"] = ktp
    return d


def context(pkg: str):
    return mod(pkg, "runtime.engine").Context()


async def wait_for(cond, timeout=5.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "condition timed out"
        await asyncio.sleep(interval)


def tokens_of(items):
    return [t for it in items for t in (it.get("token_ids") or [])]


async def stop_all(*workers):
    for rt, engine, _f, _w in workers:
        await engine.stop()
        await rt.shutdown()
        await rt.store.close()  # a TCP store server's close waits for its clients


def test_peer_prefix_fetch_injects_and_matches_tokens(np_params):
    async def go():
        a = await start_worker("memory://tpeerkv1", np_params)
        b = await start_worker("memory://tpeerkv1", np_params)
        (_, eng_a, _, wid_a), (_, eng_b, fetcher_b, _) = a, b
        try:
            toks_a = tokens_of([x async for x in eng_a.generate(make_request(), Context())])
            assert len(toks_a) == 8
            await wait_for(lambda: len(eng_a.tiers.host) >= 5)
            out_b = [x async for x in fetcher_b.generate(
                make_request(peer_prefix={"instance_id": wid_a, "num_blocks": 5}), Context())]
            assert tokens_of(out_b) == toks_a
            assert (fetcher_b.peer_fetches, fetcher_b.peer_fetch_failures) == (1, 0)
            assert eng_b.total_prefilled == len(PROMPT) - 5 * BS
            assert eng_b.inject_bytes > 0
        finally:
            await stop_all(a, b)

    asyncio.run(go())


def test_peer_delta_fetch_extends_local_prefix(np_params):
    async def go():
        a = await start_worker("memory://tpeerkv_delta", np_params)
        b = await start_worker("memory://tpeerkv_delta", np_params)
        (_, eng_a, _, wid_a), (_, eng_b, fetcher_b, _) = a, b
        try:
            toks_a = tokens_of([x async for x in eng_a.generate(make_request(), Context())])
            await wait_for(lambda: len(eng_a.tiers.host) >= 5)
            warm = [x async for x in eng_b.generate(make_request(PROMPT[:9], max_tokens=2),
                                                    Context())]
            assert tokens_of(warm)
            before = eng_b.total_prefilled
            out_b = [x async for x in fetcher_b.generate(
                make_request(peer_prefix={"instance_id": wid_a, "num_blocks": 5}), Context())]
            assert tokens_of(out_b) == toks_a
            assert fetcher_b.peer_fetches == 1
            # 2 blocks hit locally, 3 injected at block_offset 2.
            assert eng_b.total_prefilled - before == len(PROMPT) - 5 * BS
        finally:
            await stop_all(a, b)

    asyncio.run(go())


def test_peer_fetch_skipped_when_local_cache_covers(np_params):
    async def go():
        a = await start_worker("memory://tpeerkv2", np_params)
        b = await start_worker("memory://tpeerkv2", np_params)
        (_, eng_a, fetcher_a, _), (_, _, _, wid_b) = a, b
        try:
            _ = [x async for x in eng_a.generate(make_request(), Context())]
            out = [x async for x in fetcher_a.generate(
                make_request(peer_prefix={"instance_id": wid_b, "num_blocks": 5}), Context())]
            assert tokens_of(out) and fetcher_a.peer_fetches == 0
        finally:
            await stop_all(a, b)

    asyncio.run(go())


def test_router_hints_peer_and_cold_worker_reuses(np_params):
    async def go():
        url = "memory://tpeerkv3"
        a = await start_worker(url, np_params)
        b = await start_worker(url, np_params)
        rt_c = await DistributedRuntime.create(store_url=url)
        push = await rt_c.namespace("peerkv").component("backend").endpoint("generate").router(
            RouterMode.DIRECT)
        await push.discovery.wait_for_instances(2)
        router = await KvPushRouter(push, KvRouterConfig(block_size=BS,
                                                         peer_fetch_min_blocks=2)).start()
        by_wid = {a[3]: a, b[3]: b}
        try:
            ctx1 = Context()
            toks1 = tokens_of([x async for x in router.generate(make_request(), ctx1)])
            warm = ctx1.metadata["worker_instance_id"]
            cold = next(w for w in by_wid if w != warm)
            warm_eng, (cold_eng, cold_fetcher) = by_wid[warm][1], by_wid[cold][1:3]
            await wait_for(lambda: len(warm_eng.tiers.host) >= 5)
            hashes = compute_block_hashes(PROMPT, BS)[:5]
            await wait_for(lambda: router.index.find_matches(hashes).scores.get(warm, 0) >= 5)
            for i in range(4):  # load on the warm worker: the cold one is placed
                router.active.add_request(f"fake{i}", warm, 50, 0, 200)
            ctx2 = Context()
            toks2 = tokens_of([x async for x in router.generate(make_request(), ctx2)])
            assert ctx2.metadata["worker_instance_id"] == cold
            assert toks2 == toks1
            assert cold_fetcher.peer_fetches == 1
            assert cold_eng.total_prefilled == len(PROMPT) - 5 * BS
        finally:
            await router.close()
            await rt_c.shutdown()
            await stop_all(a, b)

    asyncio.run(go())


@pytest.mark.parametrize("holder,fetcher", [("dynamo_tpu", "dynamo_tpu_torch"),
                                            ("dynamo_tpu_torch", "dynamo_tpu")])
def test_peer_fetch_between_packages(np_params, holder, fetcher):
    """A worker of one package fetches a prefix from the other package's
    worker tiers over one TCP store: the KvPagePayload frames are the same
    bytes in both packages, and the tokens equal the holder's."""

    async def go():
        store = await mod("dynamo_tpu_torch", "runtime.store_net").StoreServer().start()
        a = await start_worker(store.url, np_params, holder, namespace="xpeer")
        b = await start_worker(store.url, np_params, fetcher, namespace="xpeer")
        (_, eng_a, _, wid_a), (_, eng_b, fetcher_b, _) = a, b
        try:
            toks_a = tokens_of([x async for x in eng_a.generate(make_request(),
                                                                context(holder))])
            await wait_for(lambda: len(eng_a.tiers.host) >= 5)
            out_b = [x async for x in fetcher_b.generate(
                make_request(peer_prefix={"instance_id": wid_a, "num_blocks": 5}),
                context(fetcher))]
            assert tokens_of(out_b) == toks_a
            assert (fetcher_b.peer_fetches, fetcher_b.peer_fetch_failures) == (1, 0)
            assert eng_b.total_prefilled == len(PROMPT) - 5 * BS
        finally:
            await stop_all(a, b)
            await store.close()

    asyncio.run(go())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.e2e
def test_worker_cli_peer_fetch_spawned_processes():
    """Two port worker CLIs (``--device cpu --host-kv-blocks 32``) on the
    port's store server: a prompt seeded on A through a DIRECT router, then
    sent to B with a peer_prefix hint naming A. B's stream equals A's, and
    B's counters line (SIGTERM) counts one peer fetch, 5 blocks onboarded
    from the peer and the suffix prefilled."""
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    wargs = ["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, "--device", "cpu",
             "--preset", "test-tiny", "--dtype", "float32", "--block-size", str(BS),
             "--num-kv-blocks", "64", "--max-num-seqs", "4", "--max-model-len", "128",
             "--decode-steps", "2", "--host-kv-blocks", "32"]
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(wargs, name="worker_a", env=env) as wa, \
                ManagedProcess(wargs, name="worker_b", env=env) as wb:
            wa.wait_for(r"serving test-tiny", timeout=90)
            wb.wait_for(r"serving test-tiny", timeout=90)

            async def drive():
                rt = await DistributedRuntime.create(store_url=store_url)
                try:
                    push = await rt.namespace("dynamo").component("backend").endpoint(
                        "generate").router(RouterMode.DIRECT)
                    await push.discovery.wait_for_instances(2)
                    wid_a, wid_b = sorted(push.discovery.instance_ids())
                    out_a = [x async for x in push.generate(make_request(), Context(),
                                                            instance_id=wid_a)]
                    await asyncio.sleep(1.0)  # A's write-through offload
                    out_b = [x async for x in push.generate(
                        make_request(peer_prefix={"instance_id": wid_a, "num_blocks": 5}),
                        Context(), instance_id=wid_b)]
                    assert tokens_of(out_b) == tokens_of(out_a)
                finally:
                    await rt.shutdown()
                    await rt.store.close()

            asyncio.run(drive())
            counters = []
            for w in (wa, wb):
                w.proc.send_signal(signal.SIGTERM)
                assert w.proc.wait(timeout=30) == 0
                tail = w.proc.stdout.read().strip().splitlines()
                counters.append(next(json.loads(ln) for ln in reversed(tail)
                                     if ln.startswith('{"event": "engine_counters"')))
            fetched = [c for c in counters if c["peer_fetches"]]
            assert len(fetched) == 1 and fetched[0]["peer_fetches"] == 1
            assert fetched[0]["prefilled_tokens"] == len(PROMPT) - 5 * BS
            holder = next(c for c in counters if not c["peer_fetches"])
            assert holder["tiers"]["g2_blocks"] >= 5 and holder["offload_bytes"] > 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
