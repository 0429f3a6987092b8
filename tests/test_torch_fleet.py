"""The port's fleet modules (``dynamo_tpu_torch/fleet``) against the JAX
package's, without frontend processes.

- Aggregation: ``relabel_sample``, ``merge_metrics``, ``merge_traces``
  and ``merge_ledgers`` give equal results on the same parts, the
  supervisor's flag stripping and the restart backoff (seeded) too.
- On one TCP store server: a JAX and a port ``GlobalBudget`` share one
  fleet's chunks (exclusive claims, the fleet-wide admitted count never
  above the budget, every chunk handed back on close), and a decision one
  package's cache records is found by the other's mirror, at the same
  depth.
- The prefix directory fed by an engine with a G2 tier: TorchEngine and
  TpuEngine on one workload publish the same residency (hash → warmest
  tier, G1 and G2), and either package's ``PrefixDirectory`` mirrors the
  port worker's entry.
"""

from __future__ import annotations

import asyncio
import json
import random
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.fleet import aggregate as jagg
from dynamo_tpu.fleet import budget as jbudget
from dynamo_tpu.fleet import decisions as jdec
from dynamo_tpu.fleet import directory as jdir
from dynamo_tpu.fleet.backoff import BackoffPolicy as JBackoff
from dynamo_tpu.fleet.supervisor import strip_supervisor_flags as jstrip
from dynamo_tpu.runtime.admission import AdmissionRejected as JRejected
from dynamo_tpu.runtime.store import connect_store as jconnect
from dynamo_tpu_torch.fleet import aggregate as tagg
from dynamo_tpu_torch.fleet import budget as tbudget
from dynamo_tpu_torch.fleet import decisions as tdec
from dynamo_tpu_torch.fleet import directory as tdir
from dynamo_tpu_torch.fleet.backoff import BackoffPolicy as TBackoff
from dynamo_tpu_torch.fleet.supervisor import strip_supervisor_flags as tstrip
from dynamo_tpu_torch.runtime.admission import AdmissionRejected as TRejected
from dynamo_tpu_torch.runtime.store import connect_store as tconnect
from procutil import ManagedProcess
from test_torch_tiers import jax_engine, port_engine, workload

TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
EXPO_0 = ("# HELP dt_req_total requests\n# TYPE dt_req_total counter\n"
          'dt_req_total{model="m"} 3\n# HELP dt_lat latency\n# TYPE dt_lat histogram\n'
          'dt_lat_bucket{le="+Inf"} 2\ndt_lat_sum 0.5\ndt_lat_count 2\nnot a sample line\n')
EXPO_1 = ("# HELP dt_req_total requests\n# TYPE dt_req_total counter\n"
          'dt_req_total{model="m"} 5\ndt_orphan 1\n')


def span(span_id, parent_id, name, proc, start_ts, **attrs):
    return {"name": name, "trace_id": TRACE_ID, "span_id": span_id, "parent_id": parent_id,
            "start_ts": start_ts, "duration_s": 0.01, "status": "ok", "proc": proc,
            "attrs": attrs, "events": []}


ROOT = span("aaaa", None, "http.request", "frontend-0", 1.0, endpoint="chat")
WIRE = span("bbbb", "aaaa", "wire.serve", "worker-1", 1.002)
DECODE = span("cccc", "bbbb", "engine.decode", "worker-1", 1.004, tokens=8)


@pytest.mark.parametrize("case", ["labels", "no_labels", "comment", "blank", "histogram"])
def test_relabel_sample_equal(case):
    line = {"labels": 'm_total{a="x"} 3', "no_labels": "m_total 3", "comment": "# HELP m x",
            "blank": "", "histogram": 'h_bucket{le="+Inf"} 7'}[case]
    assert tagg.relabel_sample(line, "w", "2") == jagg.relabel_sample(line, "w", "2")


@pytest.mark.parametrize("parts", [[("0", EXPO_0), ("1", EXPO_1)], [("1", EXPO_1)],
                                   [("0", EXPO_0), ("supervisor", "fleet_workers_alive 2\n")]])
def test_merge_metrics_equal(parts):
    assert tagg.merge_metrics(parts) == jagg.merge_metrics(parts)


@pytest.mark.parametrize("kind", ["scraped", "scraped_and_exported", "legacy_body"])
def test_merge_traces_equal(kind):
    if kind == "scraped":
        args = ([("0", {"spans": [ROOT]}), ("1", {"spans": [WIRE, DECODE]})],)
        kw = {}
    elif kind == "scraped_and_exported":
        args = ([("0", {"spans": [ROOT]}), ("1", {"spans": [WIRE]})],)
        kw = {"extra_spans": [dict(WIRE), DECODE]}
    else:
        body = jagg.merge_traces(TRACE_ID, [("0", {"spans": [ROOT, WIRE, DECODE]})])
        args = ([("2", {k: v for k, v in body.items() if k != "spans"})],)
        kw = {}
    got = tagg.merge_traces(TRACE_ID, *args, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jagg.merge_traces(TRACE_ID, *args, **kw), sort_keys=True)
    assert {d["span_id"] for d in got["spans"]} >= {"aaaa", "bbbb"}


def test_merge_ledgers_equal():
    parts = [("0", {"enabled": False, "requests": [{"trace_id": "a", "phases": {}}]}),
             ("1", {"enabled": True, "requests": [{"trace_id": "b"}, {"trace_id": "c"}]})]
    assert tagg.merge_ledgers(parts) == jagg.merge_ledgers(parts)
    assert tagg.merge_ledgers([]) == jagg.merge_ledgers([])


def test_supervisor_flags_and_backoff_equal():
    for argv in (["--fleet", "4", "--fleet-admin-port", "9", "--port", "8080", "--store-url",
                  "tcp://h:1", "--fleet-id", "f", "--router-mode", "kv"],
                 ["--fleet=4", "--port=0", "--host", "h"]):
        assert tstrip(argv) == jstrip(argv)
    jb, tb = (cls(base=0.5, max_delay=4.0, rng=random.Random(7)) for cls in (JBackoff, TBackoff))
    assert [tb.delay(f) for f in range(1, 9)] == [jb.delay(f) for f in range(1, 9)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def store_url():
    port = _free_port()
    proc = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                           "127.0.0.1", "--port", str(port)], name="store")
    proc.wait_for(r"store server: tcp://")
    yield f"tcp://127.0.0.1:{port}"
    proc.terminate()


def test_one_fleet_budget_shared_by_both_packages(store_url):
    async def go():
        js, ts = await jconnect(store_url), await tconnect(store_url)
        try:
            parts = []
            for wid, (mod, store) in enumerate(((jbudget, js), (tbudget, ts))):
                lease = await store.grant_lease(30.0)
                b = mod.GlobalBudget(store, "shared", lease, total=16, chunk_slots=4,
                                     worker_id=wid)
                ctl = mod.BudgetedAdmissionController(b, queue_timeout=8.0)
                await b.start()
                parts.append((b, ctl))
            # Both want everything at once: every chunk has one holder.
            demand = [b.demand_fn for b, _ in parts]  # the controllers' own
            for b, _ in parts:
                b.demand_fn = lambda: 16
            await asyncio.gather(*(b._rebalance() for b, _ in parts))
            held = [set(b.held) for b, _ in parts]
            assert held[0].isdisjoint(held[1]) and sum(b.held_slots for b, _ in parts) <= 16
            assert len(await ts.get_prefix(tbudget.budget_prefix("shared"))) == \
                len(held[0]) + len(held[1])
            for (b, _), fn in zip(parts, demand):
                b.demand_fn = fn
            admitted = peak = 0
            lock = asyncio.Lock()

            async def one(ctl):
                nonlocal admitted, peak
                try:
                    await ctl.acquire()
                except (JRejected, TRejected):
                    return 0
                async with lock:
                    admitted += 1
                    peak = max(peak, admitted)
                await asyncio.sleep(0.03)
                async with lock:
                    admitted -= 1
                ctl.release()
                return 1

            done = await asyncio.gather(*(one(ctl) for _, ctl in parts for _ in range(40)))
            assert peak <= 16 and sum(done) >= 16
            for b, _ in parts:
                await b.close()
            assert await js.get_prefix(jbudget.budget_prefix("shared")) == []
        finally:
            await js.close()
            await ts.close()

    asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decisions_recorded_by_one_package_found_by_the_other(store_url, writer):
    mods = {"jax": (jdec, jconnect), "port": (tdec, tconnect)}
    reader = "port" if writer == "jax" else "jax"

    async def go():
        ws, rs = await mods[writer][1](store_url), await mods[reader][1](store_url)
        fid = f"dec-{writer}"
        cw = await mods[writer][0].RouterDecisionCache(ws, fid).start()
        cr = await mods[reader][0].RouterDecisionCache(rs, fid).start()
        try:
            turn1 = [11, 22, 33]
            cw.record("m", turn1, worker=0xA)
            for _ in range(100):
                if cr.lookup("m", turn1 + [44]) is not None:
                    break
                await asyncio.sleep(0.02)
            assert cr.lookup("m", turn1 + [44]) == cw.lookup("m", turn1 + [44]) == (0xA, 3)
            assert cr.lookup("other", turn1) is None and cr.lookup("m", [9, 8]) is None
            await cw.close(flush=True)  # a drained writer revokes its entries
            for _ in range(100):
                if cr.lookup("m", turn1) is None:
                    break
                await asyncio.sleep(0.02)
            assert cr.lookup("m", turn1) is None
        finally:
            await cr.close()
            await ws.close()
            await rs.close()

    asyncio.run(asyncio.wait_for(go(), 30))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_directory_fed_by_engines_with_a_g2_tier(store_url, np_params):
    """test_torch_tiers.py's G2 workload (prompts that leave G1 and are
    onboarded back) on both engines, each feeding its package's
    DirectoryPublisher from the pool and the tiers: the same published
    residency, and the port worker's entry mirrored by both packages'
    PrefixDirectory."""

    async def publish(pkg, make, dir_mod, connect, worker_id):
        store = await connect(store_url)
        pub = await dir_mod.DirectoryPublisher(store, f"dir-{pkg}", worker_id,
                                               flush_interval=30.0).start()
        eng = make(np_params, host_kv_blocks=64)
        eng.pool.set_event_sink(pub.pool_sink)
        eng.tiers.set_event_sink(pub.tier_sink)
        out = await workload(eng)
        await pub.flush()
        entry = await store.get(dir_mod.kvdir_key(f"dir-{pkg}", worker_id))
        return store, pub, out, json.loads(entry.value)

    async def go():
        js, jpub, jout, jval = await publish("jax", jax_engine, jdir, jconnect, 0x1)
        ts, tpub, tout, tval = await publish("port", port_engine, tdir, tconnect, 0x2)
        try:
            assert tout["stats"] == jout["stats"] and tout["stats"]["onboarded_blocks"] > 0
            jh = {h: tier for h, (tier, _seq) in jval["h"].items()}
            th = {h: tier for h, (tier, _seq) in tval["h"].items()}
            assert th == jh and set(th.values()) == {1, 2}
            # Both packages' mirrors read the port worker's entry.
            for mod, store in ((jdir, js), (tdir, ts)):
                mirror = await mod.PrefixDirectory(store, "dir-port").start()
                try:
                    for _ in range(100):
                        if mirror.worker_ids() == [0x2]:
                            break
                        await asyncio.sleep(0.02)
                    assert mirror.worker_ids() == [0x2]
                    for h, tier in th.items():
                        assert mirror.holders(int(h, 16)) == {0x2: tier}
                finally:
                    await mirror.close()
            await tpub.close()  # a closed publisher withdraws its entry
            assert await ts.get(tdir.kvdir_key("dir-port", 0x2)) is None
        finally:
            await jpub.close()
            await js.close()
            await ts.close()

    asyncio.run(asyncio.wait_for(go(), 120))
