"""The port's WorkerRoleManager on a real runtime (memory store), with a
test-tiny ``TorchEngine`` on the CPU where ``tests/test_worker_roles.py``
uses the mocker (not ported): registration truth, drain-ordered pool moves
with an in-flight stream completing across the move, retirement leaving
zero keys, the admin RPC surface the autoscaler actuates through,
``read_pools`` with junk entries and the replica scale-down. Beyond the
JAX file: with a decode peer present, a pool move and a retirement
RELOCATE the running stream through live migration (``worker/migrate.py``)
and the client stream, behind the ``Migration`` operator, equals the
unmigrated one; the admin verbs of migration answer typed.
"""

from __future__ import annotations

import asyncio
import json
from types import SimpleNamespace

import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.planner.actions import POOL_DECODE, POOL_PREFILL, PoolMove, ReplicaScale
from dynamo_tpu_torch.planner.actuate import RuntimeActuator, read_pools, worker_key
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.worker.roles import ADMIN_COMPONENT, ADMIN_ENDPOINT, WorkerRoleManager

NS = "roles-test"
ARGS = dict(block_size=4, num_kv_blocks=128, max_num_seqs=8, max_model_len=256,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wargs(disagg: str = "auto") -> SimpleNamespace:
    return SimpleNamespace(
        namespace=NS, component="backend", prefill_component="prefill",
        endpoint="generate", engine="tpu", disagg=disagg,
        max_local_prefill_length=512, no_disagg_stream=False,
        prefill_dispatch="queue",
    )


async def make_worker(url: str, role: str, disagg: str = "auto"):
    rt = await DistributedRuntime.create(store_url=url)
    engine = await TorchEngine(EngineArgs(model=ModelConfig(), **ARGS), seed=0).start()
    bc = KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(bc.publish)
    card = ModelDeploymentCard(
        name="roles-model", kv_cache_block_size=4,
        eos_token_ids=[ByteTokenizer.EOS], context_length=256,
    )
    mgr = await WorkerRoleManager(rt, engine, [card], wargs(disagg), bc).start(role)
    return rt, mgr


async def close(*pairs):
    for rt, mgr in pairs:
        await mgr.close()
        await mgr.engine.stop()
        await rt.shutdown()


def req_dict(i: int, max_tokens: int = 8) -> dict:
    return {
        "model": "roles-model",
        "token_ids": list(range(16)),
        "stop": {"max_tokens": max_tokens, "ignore_eos": True},
        "sampling": {"seed": i, "temperature": 0.0},
        "eos_token_ids": [ByteTokenizer.EOS],
    }


async def admin_router(rt):
    return await (rt.namespace(NS).component(ADMIN_COMPONENT)
                  .endpoint(ADMIN_ENDPOINT).router(RouterMode.DIRECT))


async def rpc(admin, lease: int, payload: dict) -> dict:
    frames = []
    async for f in admin.generate(payload, Context(), instance_id=lease):
        frames.append(f)
    return frames[-1]


def test_role_round_trip_registrations_and_cards():
    async def go():
        url = "memory://troles-roundtrip"
        wrt, mgr = await make_worker(url, POOL_DECODE)
        ort = await DistributedRuntime.create(store_url=url)
        act = RuntimeActuator(ort.store, NS, await admin_router(ort), converge_timeout_s=10)

        pools = await act.pools()
        assert len(pools[POOL_DECODE]) == 1 and not pools[POOL_PREFILL]
        assert len(await ort.store.get_prefix("models/")) == 1
        lease = await wrt.primary_lease()
        reg = json.loads((await ort.store.get(worker_key(NS, lease))).value)
        assert reg["role"] == POOL_DECODE and reg["instance_id"] == lease
        # A decode-role worker serves kv_fetch (a migration destination's
        # pull) and kv_prefix (peer prefix fetch) beside generate.
        keys = [e.key for e in await ort.store.get_prefix(f"instances/{NS}/backend/")]
        for ep in ("generate", "kv_fetch", "kv_prefix", "embed", "clear_kv"):
            assert any(f"/backend/{ep}:" in k for k in keys), ep

        await act.move(PoolMove(worker="", instance_id=0, src=POOL_DECODE, dst=POOL_PREFILL))
        pools = await act.pools()
        assert len(pools[POOL_PREFILL]) == 1 and not pools[POOL_DECODE]
        assert await ort.store.get_prefix("models/") == []
        assert any("/prefill/generate:" in e.key
                   for e in await ort.store.get_prefix(f"instances/{NS}/"))

        await act.move(PoolMove(worker="", instance_id=0, src=POOL_PREFILL, dst=POOL_DECODE))
        pools = await act.pools()
        assert len(pools[POOL_DECODE]) == 1
        assert len(await ort.store.get_prefix("models/")) == 1

        await close((wrt, mgr))
        await ort.shutdown()

    asyncio.run(go())


def test_in_flight_stream_completes_across_pool_move():
    """The zero-failure drain contract with no peer to relocate to: a
    stream running when the move is commanded finishes with its full token
    count; the move completes after."""

    async def go():
        url = "memory://troles-drain"
        wrt, mgr = await make_worker(url, POOL_DECODE)
        ort = await DistributedRuntime.create(store_url=url)
        act = RuntimeActuator(ort.store, NS, await admin_router(ort), converge_timeout_s=20)
        gen = await (ort.namespace(NS).component("backend").endpoint("generate")
                     .router(RouterMode.ROUND_ROBIN))
        first = asyncio.Event()

        async def stream():
            tokens = 0
            async for frame in gen.generate(req_dict(1, max_tokens=200), Context()):
                if isinstance(frame, dict):
                    tokens += len(frame.get("token_ids") or ())
                    if tokens:
                        first.set()
            return tokens

        s = asyncio.get_running_loop().create_task(stream())
        await asyncio.wait_for(first.wait(), 30)
        assert not s.done()
        await act.move(PoolMove(worker="", instance_id=0, src=POOL_DECODE, dst=POOL_PREFILL))
        assert await s == 200, "the stream lost tokens across the move"
        assert len((await act.pools())[POOL_PREFILL]) == 1

        await close((wrt, mgr))
        await ort.shutdown()

    asyncio.run(go())


def test_retire_drains_and_leaves_zero_keys():
    async def go():
        url = "memory://troles-retire"
        wrt, mgr = await make_worker(url, POOL_DECODE)
        ort = await DistributedRuntime.create(store_url=url)
        admin = await admin_router(ort)
        gen = await (ort.namespace(NS).component("backend").endpoint("generate")
                     .router(RouterMode.ROUND_ROBIN))
        first = asyncio.Event()

        async def stream():
            tokens = 0
            async for frame in gen.generate(req_dict(2, max_tokens=150), Context()):
                if isinstance(frame, dict):
                    tokens += len(frame.get("token_ids") or ())
                    if tokens:
                        first.set()
            return tokens

        s = asyncio.get_running_loop().create_task(stream())
        await asyncio.wait_for(first.wait(), 30)
        ack = await rpc(admin, await wrt.primary_lease(), {"cmd": "retire"})
        assert ack == {"ok": True, "retiring": True}
        assert await s == 150  # the in-flight stream drained to completion
        await mgr.retired.wait()
        for prefix in ("autoscaler/", "models/"):
            assert await ort.store.get_prefix(prefix) == [], prefix
        assert await ort.store.get_prefix(f"instances/{NS}/backend/generate") == []

        await close((wrt, mgr))
        await ort.shutdown()

    asyncio.run(go())


def test_admin_rpc_rejects_unknown_commands_and_roles():
    async def go():
        url = "memory://troles-admin"
        wrt, mgr = await make_worker(url, POOL_DECODE)
        ort = await DistributedRuntime.create(store_url=url)
        admin = await admin_router(ort)
        lease = await wrt.primary_lease()

        assert "error" in await rpc(admin, lease, {"cmd": "bogus"})
        assert "error" in await rpc(admin, lease, {"cmd": "set_role", "role": "sideways"})
        status = await rpc(admin, lease, {"cmd": "status"})
        assert status["role"] == POOL_DECODE and status["ok"]
        same = await rpc(admin, lease, {"cmd": "set_role", "role": POOL_DECODE})
        assert same["role"] == POOL_DECODE
        # Migration verbs answer typed: no peer, nothing running, an
        # unknown handle.
        assert await rpc(admin, lease, {"cmd": "migrate_out"}) == {"ok": False,
                                                                  "reason": "no_running"}
        assert await rpc(admin, lease, {"cmd": "migrate_out", "request_id": "r"}) == {
            "ok": False, "reason": "no_peer"}
        assert await rpc(admin, lease, {"cmd": "migrate_out", "request_id": "r",
                                        "dest_instance": lease}) == {"ok": False,
                                                                     "reason": "self"}
        commit = await rpc(admin, lease, {"cmd": "migrate_in_commit", "handle": "h"})
        assert commit == {"error": "unknown migration handle 'h'"}
        assert await rpc(admin, lease, {"cmd": "migrate_in_abort", "handle": "h"}) == {"ok": True}
        # kv_adopt without tiers on this worker.
        assert await rpc(admin, lease, {"cmd": "kv_adopt", "hashes": [1]}) == {
            "error": "no kv tiers on this worker"}

        await close((wrt, mgr))
        await ort.shutdown()

    asyncio.run(go())


def test_read_pools_tolerates_junk_entries():
    async def go():
        from dynamo_tpu_torch.runtime.store import connect_store

        store = await connect_store("memory://troles-junk")
        await store.put(f"autoscaler/{NS}/workers/zz", b"not json")
        await store.put(f"autoscaler/{NS}/workers/1f",
                        json.dumps({"role": POOL_DECODE, "instance_id": 31}).encode())
        await store.put(f"autoscaler/{NS}/workers/2f",
                        json.dumps({"role": "sideways", "instance_id": 47}).encode())
        pools = await read_pools(store, NS)
        assert [w.instance_id for w in pools[POOL_DECODE]] == [31]
        assert pools[POOL_PREFILL] == []

    asyncio.run(go())


def test_replica_scale_down_retires_distinct_victims():
    """The retire RPC acks before the registration key vanishes (background
    drain): a multi-step shrink must not re-pick a still-registered victim."""

    async def go():
        url = "memory://troles-shrink"
        workers = [await make_worker(url, POOL_DECODE) for _ in range(3)]
        ort = await DistributedRuntime.create(store_url=url)
        act = RuntimeActuator(ort.store, NS, await admin_router(ort), converge_timeout_s=15)
        assert len((await act.pools())[POOL_DECODE]) == 3

        await act.scale(ReplicaScale(pool=POOL_DECODE, target=1, current=3))
        pools = await act.pools()
        assert len(pools[POOL_DECODE]) == 1, pools
        assert len([m for _, m in workers if m.retired.is_set()]) == 2

        await close(*workers)
        await ort.shutdown()

    asyncio.run(go())


async def _reference(prompt_req: dict) -> list[int]:
    e = await TorchEngine(EngineArgs(model=ModelConfig(), **ARGS), seed=0).start()
    got = []
    async for item in e.generate(dict(prompt_req), Context()):
        got.extend(item.get("token_ids") or [])
    await e.stop()
    return got


@pytest.mark.parametrize("how", ["set_role", "retire"])
def test_pool_move_and_retirement_relocate_the_running_stream(how):
    """Two decode workers (``--disagg off``): a stream runs on A behind the
    Migration operator; a pool move of A to prefill (or its retirement)
    relocates the stream to B through workerctl/admin instead of draining
    it, and the client stream equals the unmigrated one. A retired worker
    leaves no autoscaler key."""

    async def go():
        url = f"memory://troles-relocate-{how}"
        a = await make_worker(url, POOL_DECODE, disagg="off")
        b = await make_worker(url, POOL_DECODE, disagg="off")
        ort = await DistributedRuntime.create(store_url=url)
        admin = await admin_router(ort)
        push = await (ort.namespace(NS).component("backend").endpoint("generate")
                      .router(RouterMode.DIRECT))
        await push.discovery.wait_for_instances(2)
        router = await KvPushRouter(push, KvRouterConfig(block_size=4,
                                                         use_kv_events=False)).start()
        op = Migration(router, migration_limit=0)
        req = req_dict(3, max_tokens=180)
        ref = await _reference(req)
        lease_a = await a[0].primary_lease()
        req = dict(req, kv_transfer_params={"migration_resume": {"instance": lease_a}})
        got, first = [], asyncio.Event()

        async def stream():
            async for item in op.generate(dict(req), Context()):
                got.extend(item.get("token_ids") or [])
                if got:
                    first.set()

        s = asyncio.get_running_loop().create_task(stream())
        await asyncio.wait_for(first.wait(), 30)
        assert a[1].engine.list_running()
        if how == "set_role":
            st = await rpc(admin, lease_a, {"cmd": "set_role", "role": POOL_PREFILL})
            assert st["role"] == POOL_PREFILL
        else:
            assert (await rpc(admin, lease_a, {"cmd": "retire"}))["retiring"]
            await asyncio.wait_for(a[1].retired.wait(), 30)
            assert await ort.store.get(worker_key(NS, lease_a)) is None
        await asyncio.wait_for(s, 60)
        assert got == ref and len(got) == 180
        assert a[1].migrator.outcomes == {"ok": 1} and op.counts == {"resume": 1}
        assert b[1].engine.total_generated > 0
        await router.close()
        await close(a, b)
        await ort.shutdown()

    asyncio.run(go())
