"""Live sequence migration between two port engines, held against the JAX
engines (CPU, memory runtime).

Mirrors ``tests/test_migration_live.py`` on two ``TorchEngine``s: two
engines on one component behind a ``KvPushRouter`` and the ``Migration``
operator, each with a real ``MigrationCoordinator``/``MigrationReceiver``
behind a ``workerctl/admin`` shim (the roles.py wiring, minus pool
management). Every case runs twice, on the port's modules and on the JAX
package's, with the same weights (JAX ``init_params`` exported to numpy,
test-tiny in float32): the clean relocation, the 9-cell chaos matrix
(phase × victim, ``migration_cut_plan``), preemption racing a migration
and the offer before a kill. In each, the client stream must complete
equal to the unmigrated one, and the token streams, the typed fallback
reasons and the ``migration_*`` counters of the two packages must be
equal. Requests are seeded.
"""

from __future__ import annotations

import asyncio
import importlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine.weights import params_from_numpy

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
N = 64  # tokens per stream: room for the relocation before the stream ends


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mods(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    eng = m("engine.engine")
    mig = m("worker.migrate")
    return SimpleNamespace(
        pkg=pkg, config=m("engine.config"),
        Engine=getattr(eng, "TorchEngine", None) or eng.TpuEngine,
        KvPushRouter=m("kv_router.router").KvPushRouter,
        KvRouterConfig=m("kv_router.router").KvRouterConfig,
        PrefillHandler=m("llm.disagg").PrefillHandler,
        Migration=m("llm.migration").Migration,
        ChaosInjector=m("runtime.chaos").ChaosInjector,
        ChaosConfig=m("runtime.config").ChaosConfig,
        DistributedRuntime=m("runtime.distributed").DistributedRuntime,
        Context=m("runtime.engine").Context,
        RouterMode=m("runtime.push_router").RouterMode,
        MigrationCoordinator=mig.MigrationCoordinator,
        MigrationReceiver=mig.MigrationReceiver,
        register_migration_metrics=mig.register_migration_metrics,
    )


def make_engine(M, params, **kw):
    cfg = M.config
    if M.pkg == "dynamo_tpu":
        return M.Engine(cfg.EngineArgs(model=cfg.ModelConfig(), attn_impl="xla",
                                       **{**ARGS, **kw}), params=params)
    return M.Engine(cfg.EngineArgs(model=cfg.ModelConfig(), device="cpu", **{**ARGS, **kw}),
                    params=params_from_numpy(params, "cpu", torch.float32))


def request(prompt, max_tokens=N, temperature=0.0, seed=0) -> dict:
    return {"model": "t", "token_ids": list(prompt),
            "sampling": {"temperature": temperature, "seed": seed},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


class Worker:
    def __init__(self, rt, engine, receiver, coordinator, instance_id):
        self.rt, self.engine = rt, engine
        self.receiver, self.coordinator = receiver, coordinator
        self.instance_id = instance_id

    async def stop(self):
        await self.receiver.close()
        await self.engine.stop()
        await self.rt.shutdown()


async def make_worker(M, params, url: str, ns: str, chaos=None) -> Worker:
    """One decode worker: engine + generate/kv_fetch + the migrate admin
    verbs, wired as the JAX test wires them."""
    rt = await M.DistributedRuntime.create(store_url=url)
    engine = await make_engine(M, params).start()
    comp = rt.namespace(ns).component("backend")
    metrics = M.register_migration_metrics(rt.metrics)
    receiver = M.MigrationReceiver(rt, ns, chaos=chaos, metrics=metrics)

    async def gen_handler(payload, ctx):
        if isinstance(payload, dict):
            mr = (payload.get("kv_transfer_params") or {}).get("migration_resume")
            if isinstance(mr, dict) and mr.get("handle"):
                staged = receiver.take(mr["handle"])
                if staged is not None:
                    payload = dict(payload)
                    ktp = dict(payload.get("kv_transfer_params") or {})
                    ktp["inject"] = staged
                    payload["kv_transfer_params"] = ktp
        async for item in engine.generate(payload, ctx):
            yield item

    gh = await comp.endpoint("generate").serve(gen_handler)
    await comp.endpoint("kv_fetch").serve(M.PrefillHandler(engine, chaos=chaos).kv_fetch)
    acomp = rt.namespace(ns).component("workerctl")
    coordinator = M.MigrationCoordinator(
        engine, await acomp.endpoint("admin").router(M.RouterMode.DIRECT), "backend",
        gh.instance.instance_id, chaos=chaos, metrics=metrics)

    async def admin(payload, ctx):
        payload = payload or {}
        cmd = payload.get("cmd")
        try:
            if cmd == "migrate_out":
                yield await coordinator.migrate_out(payload.get("request_id", ""),
                                                    int(payload.get("dest_instance") or 0))
            elif cmd == "migrate_in_start":
                yield await receiver.start_pull(payload.get("handle", ""),
                                                payload.get("source_component", ""),
                                                int(payload.get("source_instance") or 0))
            elif cmd == "migrate_in_commit":
                yield await receiver.commit(payload.get("handle", ""),
                                            int(payload.get("kv_blocks") or 0))
            elif cmd == "migrate_in_abort":
                yield await receiver.abort(payload.get("handle", ""))
            else:
                yield {"error": f"unknown admin cmd {cmd!r}"}
        except Exception as e:  # noqa: BLE001 — the shim answers typed, as roles.py does
            yield {"error": f"{type(e).__name__}: {e}"}

    await acomp.endpoint("admin").serve(admin)
    return Worker(rt, engine, receiver, coordinator, gh.instance.instance_id)


class Decisions:
    """Records the router's stickiness writes (hashes, worker)."""

    def __init__(self):
        self.records: list = []

    def lookup(self, hashes):
        return None

    def record(self, hashes, wid):
        self.records.append((tuple(hashes), wid))


class Cluster:
    """Two workers, the Migration operator over a KvPushRouter and an admin
    router, on one package's modules."""

    def __init__(self, M, params, url: str, chaos=None):
        self.M, self.params, self.url, self.chaos = M, params, url, chaos
        self.ns = "mig"

    async def start(self):
        M = self.M
        self.a = await make_worker(M, self.params, self.url, self.ns, self.chaos)
        self.b = await make_worker(M, self.params, self.url, self.ns, self.chaos)
        self.frt = await M.DistributedRuntime.create(store_url=self.url)
        ns = self.frt.namespace(self.ns)
        push = await ns.component("backend").endpoint("generate").router(M.RouterMode.DIRECT)
        self.decisions = Decisions()
        self.router = await M.KvPushRouter(push, M.KvRouterConfig(block_size=4,
                                                                  use_kv_events=False),
                                           decisions=self.decisions).start()
        self.operator = M.Migration(self.router, migration_limit=3)
        self.admin = await ns.component("workerctl").endpoint("admin").router(M.RouterMode.DIRECT)
        return self

    def source(self):
        for w, other in ((self.a, self.b), (self.b, self.a)):
            if w.engine.list_running():
                return w, other
        return None, None

    async def migrate_rpc(self, src: Worker, request_id: str, dst: Worker) -> dict:
        last = {}
        async for frame in self.admin.generate(
                {"cmd": "migrate_out", "request_id": request_id,
                 "dest_instance": dst.instance_id},
                self.M.Context(), instance_id=src.instance_id):
            if isinstance(frame, dict):
                last = frame
        return last

    async def stop(self):
        await self.router.close()
        await self.frt.shutdown()
        await self.a.stop()
        await self.b.stop()

    def metrics_text(self) -> str:
        return self.a.rt.metrics.render() + self.b.rt.metrics.render()


async def drained(*engines, timeout=5.0) -> bool:
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if all(not e.list_running() for e in engines):
            return True
        await asyncio.sleep(0.01)
    return False


async def reference(M, params, req) -> list[int]:
    e = await make_engine(M, params).start()
    got = []
    async for item in e.generate(dict(req), M.Context()):
        got.extend(item.get("token_ids") or [])
    await e.stop()
    return got


RACED = ("not_running", "finished")


async def stream_and_migrate(cl: Cluster, req: dict, trigger_at: int = 4):
    """One request through the Migration operator; once ``trigger_at``
    tokens arrived, migrate_out from whichever worker decodes it →
    (tokens, finish, reply or None)."""
    got, finish = [], []

    async def run():
        async for item in cl.operator.generate(dict(req), cl.M.Context()):
            got.extend(item.get("token_ids") or [])
            if item.get("finish_reason"):
                finish.append(item["finish_reason"])

    task = asyncio.get_running_loop().create_task(run())
    reply = None
    try:
        for _ in range(4000):
            if len(got) >= trigger_at or task.done():
                break
            await asyncio.sleep(0.001)
        src, dst = cl.source()
        if src is not None:
            running = src.engine.list_running()
            if running:
                reply = await cl.migrate_rpc(src, running[0], dst)
        await asyncio.wait_for(task, 120)
    finally:
        if not task.done():
            task.cancel()
    return got, finish, reply


def migrated(reply) -> bool:
    """True when the migrate_out reached the protocol (not raced by the
    stream's end)."""
    return reply is not None and reply.get("reason") not in RACED


_SERIES = re.compile(r"^(?:dynamo_tpu_)?(migration_[a-z_]+(?:\{[^}]*\})?) ([0-9.eE+-]+)$", re.M)


def migration_series(text: str) -> dict:
    """The migration_* samples of a registry render. Histogram samples are
    left out (they hold wall times) and the KV bytes reduce to whether any
    moved: how many blocks a stream carries depends on when the cutover
    lands, on either engine."""
    out = {}
    for name, val in _SERIES.findall(text):
        if "_seconds" in name:
            continue
        out[name] = out.get(name, 0.0) + float(val)
    if "migration_kv_bytes_total" in out:
        out["migration_kv_bytes_total"] = out["migration_kv_bytes_total"] > 0
    return out


def both(fn):
    """Run ``fn(M)`` on the JAX package's modules and on the port's, each
    in its own event loop → {pkg: result}."""
    return {pkg: asyncio.run(fn(mods(pkg))) for pkg in PKGS}


def prompt_of(seed: int, n: int = 26) -> list[int]:
    return np.random.default_rng(seed).integers(1, JCfg().vocab_size - 1, size=n).tolist()


def test_live_migration_equal_streams_and_counters(params):
    """Clean relocation: the stream completes equal to the unmigrated one,
    the router rebinds to the destination, and the two packages agree on
    the tokens, the ledgers and the series."""
    req = request(prompt_of(11))

    async def go(M):
        ref = await reference(M, params, req)
        cl = await Cluster(M, params, f"memory://tmiglive1-{M.pkg}").start()
        try:
            for _ in range(5):
                cl.decisions.records.clear()
                got, finish, reply = await stream_and_migrate(cl, req)
                assert got == ref and finish == ["length"]
                if reply is not None and reply.get("ok"):
                    break
            assert reply is not None and reply.get("ok"), reply
            assert await drained(cl.a.engine, cl.b.engine)
            recs = cl.decisions.records
            return {
                "ref": ref, "got": got, "handle_prefix": reply["handle"][:4],
                "kv_blocks_positive": reply["kv_blocks"] > 0,
                "kv_bytes_positive": reply["kv_bytes"] > 0,
                "outcomes": sorted(cl.a.coordinator.outcomes.items())
                + sorted(cl.b.coordinator.outcomes.items()),
                "resume": cl.operator.counts.get("resume", 0),
                "redispatch": cl.operator.counts.get("redispatch", 0),
                "rebound": len(recs) >= 2 and recs[-1][1] != recs[0][1],
                "series": migration_series(cl.metrics_text()),
            }
        finally:
            await cl.stop()

    res = both(go)
    j, t = res["dynamo_tpu"], res["dynamo_tpu_torch"]
    assert t["ref"] == j["ref"] and len(t["ref"]) == N
    assert t == j
    assert t["resume"] == 1 and t["redispatch"] == 0 and t["rebound"]
    assert t["series"]['migration_attempts_total{outcome="ok"}'] == 1
    assert t["series"]["migration_inflight"] == 0
    assert t["series"]["migration_kv_bytes_total"] > 0


CELLS = [(phase, victim) for phase in ("streaming", "cutover", "rebind")
         for victim in ("source", "dest", "store")]


@pytest.mark.parametrize("phase,victim", CELLS)
def test_chaos_cell_equal_streams_reasons_and_counters(params, phase, victim):
    """Kill the source, the destination or the store at each phase: the
    stream completes equal to the unmigrated one in every cell (a typed
    fallback to in-place decode, or a handoff that re-prefills), and both
    packages give the same reply, fallback reasons, chaos cuts and
    migration series."""
    req = request(prompt_of(12))

    async def go(M):
        ref = await reference(M, params, req)
        chaos = M.ChaosInjector(M.ChaosConfig(enabled=True, seed=7,
                                              migration_cut_plan=f"{phase}:{victim}"))
        cl = await Cluster(M, params, f"memory://tmiglive2-{phase}-{victim}-{M.pkg}",
                           chaos=chaos).start()
        try:
            for _ in range(5):
                cuts = chaos.stats.migration_cuts
                got, finish, reply = await stream_and_migrate(cl, req)
                assert got == ref and finish == ["length"], f"{phase}:{victim} diverged"
                assert await drained(cl.a.engine, cl.b.engine)
                if migrated(reply):
                    break
            assert migrated(reply), reply
            reasons = {**cl.a.coordinator.fallback_reasons, **cl.b.coordinator.fallback_reasons}
            return {"ref": ref, "got": got, "ok": reply.get("ok"),
                    "reason": reply.get("reason"), "reasons": reasons,
                    "cuts": chaos.stats.migration_cuts - cuts,
                    "resume": cl.operator.counts.get("resume", 0),
                    "series": migration_series(cl.metrics_text())}
        finally:
            await cl.stop()

    res = both(go)
    j, t = res["dynamo_tpu"], res["dynamo_tpu_torch"]
    assert t["ref"] == j["ref"]
    assert t == j
    if phase == "streaming" or (phase, victim) in (("cutover", "source"), ("cutover", "dest"),
                                                   ("cutover", "store"), ("rebind", "source")):
        assert t["ok"] is False and t["reason"] == f"chaos:{phase}:{victim}"
        assert t["reasons"] == {f"chaos:{phase}:{victim}": 1} and t["cuts"] == 1
        assert t["series"][f'migration_fallback_total{{reason="chaos:{phase}:{victim}"}}'] == 1
    else:  # rebind:dest / rebind:store still hand off (re-prefill from the identity)
        assert t["ok"] is True and t["resume"] == 1


def test_preemption_during_migration_equal_dicts(params):
    """A preemption racing the streaming phase tears the migration down:
    the sequence requeues, recomputes, and the stream completes equal to
    the unmigrated one; the protocol's dicts are the JAX engine's."""
    req = request(prompt_of(13, 18), 24)

    async def go(M):
        ref = await reference(M, params, req)
        e = await make_engine(M, params, decode_steps=1).start()
        got, finish = [], []

        async def run():
            async for item in e.generate(dict(req), M.Context()):
                got.extend(item.get("token_ids") or [])
                if item.get("finish_reason"):
                    finish.append(item["finish_reason"])

        task = asyncio.get_running_loop().create_task(run())
        for _ in range(4000):
            if len(got) >= 4 or task.done():
                break
            await asyncio.sleep(0.001)
        rid = e.list_running()[0]

        def begin_then_preempt():
            res = e.migration_begin(rid)
            again = e.migration_begin(rid)
            s = next(x for x in e._running if x.request_id == rid)
            e._preempt(s)
            return res, again, e.migration_status(rid), e.migration_cutover(rid)

        res, again, st, cut = await e.run_on_engine_thread(begin_then_preempt)
        await asyncio.wait_for(task, 60)
        preempted = sum(e.total_preemptions_by.values())
        await e.stop()
        return {"ref": ref, "got": got, "finish": finish, "ok": res["ok"],
                "handle_prefix": res["handle"][:4], "again": again, "status": st,
                "cutover": cut, "preemptions": preempted}

    res = both(go)
    j, t = res["dynamo_tpu"], res["dynamo_tpu_torch"]
    assert t == j
    assert t["got"] == t["ref"] and t["finish"] == ["length"]
    assert t["again"] == {"error": "already_migrating"}
    assert t["status"] == {"error": "no_migration"} == t["cutover"]
    assert t["preemptions"] == 1


def test_preemption_offers_migration_before_killing(params):
    """Under KV pressure the engine fires the offer hook for the victim and
    waits a bounded grace before preempting: an unserved offer degrades to
    the plain preemption, the streams complete, and both packages offer
    and preempt alike."""
    rng = np.random.default_rng(14)
    reqs = [request(rng.integers(1, JCfg().vocab_size - 1, size=16).tolist(), 24, seed=i)
            for i in range(2)]

    async def go(M):
        # 14 blocks of 4: two 16-token prompts decoding 24 tokens collide.
        e = await make_engine(M, params, num_kv_blocks=14, max_num_seqs=2).start()
        e.preempt_offer_grace_s = 0.05
        offered = []
        e.migration_offer = offered.append

        async def run(r):
            toks, fin = [], None
            async for item in e.generate(dict(r), M.Context()):
                toks.extend(item.get("token_ids") or [])
                fin = item.get("finish_reason") or fin
            return toks, fin

        outs = await asyncio.gather(*(run(r) for r in reqs))
        out = {"outs": outs, "offers": len(offered), "distinct": len(set(offered)),
               "preempted": dict(e.total_preemptions_by)}
        await e.stop()
        return out

    res = both(go)
    j, t = res["dynamo_tpu"], res["dynamo_tpu_torch"]
    assert t == j
    assert sum(t["preempted"].values()) > 0 and t["offers"] >= 1
    assert all(fin == "length" and len(toks) == 24 for toks, fin in t["outs"])
