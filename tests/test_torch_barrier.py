"""The port's startup barrier (``runtime/barrier.py``) across the packages.

On one TCP store server, a leader of one package and workers of the other
(and of both) meet at one barrier: every worker gets the leader's data, a
worker that checks in before its leader arrives still releases, and a
leader missing a worker times out in both packages alike. Then the port's
barrier alone on an in-memory store, as tests/test_barrier.py runs the
JAX one.
"""

from __future__ import annotations

import asyncio
import socket

import pytest

from dynamo_tpu.runtime import barrier as jb
from dynamo_tpu.runtime.store import connect_store as jconnect
from dynamo_tpu_torch.runtime import barrier as tb
from dynamo_tpu_torch.runtime.store import connect_store as tconnect
from procutil import ManagedProcess

PKGS = {"jax": (jb, jconnect), "port": (tb, tconnect)}


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


@pytest.mark.parametrize("leader,workers", [("jax", ["port", "port"]),
                                            ("port", ["jax", "jax"]),
                                            ("port", ["jax", "port"])])
def test_leader_and_workers_of_either_package_release_together(store_url, leader, workers):
    name = f"boot-{leader}-{'-'.join(workers)}"

    async def go():
        lb, lconnect = PKGS[leader]
        lstore = await lconnect(store_url)
        wstores = [await PKGS[w][1](store_url) for w in workers]
        try:
            lease = await lstore.grant_lease(10.0)

            async def worker(i, pkg):
                if i == 0:
                    await asyncio.sleep(0.1)  # one worker arrives after the leader
                return await PKGS[pkg][0].worker_barrier(wstores[i], name, f"w{i}", timeout=10)

            early = asyncio.ensure_future(worker(1, workers[1]))
            await asyncio.sleep(0.1)  # and one before it
            results = await asyncio.gather(
                lb.leader_barrier(lstore, name, len(workers), data=b"mesh-config",
                                  lease_id=lease, timeout=10),
                worker(0, workers[0]), early)
            await lstore.revoke_lease(lease)
            return results[1:]
        finally:
            for s in (lstore, *wstores):
                await s.close()

    assert asyncio.run(asyncio.wait_for(go(), 30)) == [b"mesh-config"] * len(workers)


@pytest.mark.parametrize("leader", ["jax", "port"])
def test_leader_missing_a_worker_times_out(store_url, leader):
    other = "port" if leader == "jax" else "jax"
    name = f"short-{leader}"

    async def go():
        lstore, wstore = await PKGS[leader][1](store_url), await PKGS[other][1](store_url)
        try:
            task = asyncio.ensure_future(
                PKGS[other][0].worker_barrier(wstore, name, "w0", timeout=1.0))
            with pytest.raises(PKGS[leader][0].BarrierTimeout):
                await PKGS[leader][0].leader_barrier(lstore, name, 2, timeout=0.3)
            with pytest.raises(PKGS[other][0].BarrierTimeout):
                await task
        finally:
            await lstore.close()
            await wstore.close()

    asyncio.run(asyncio.wait_for(go(), 30))


def test_port_barrier_on_a_memory_store():
    async def go():
        store = await tconnect("memory://torch_barrier")
        results = await asyncio.gather(
            tb.leader_barrier(store, "boot", 3, data=b"d", timeout=5),
            *(tb.worker_barrier(store, "boot", f"w{i}", timeout=5) for i in range(3)))
        await store.close()
        return results[1:]

    assert asyncio.run(asyncio.wait_for(go(), 30)) == [b"d"] * 3
