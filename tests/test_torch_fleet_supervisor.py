"""The port's frontend fleet (``python -m dynamo_tpu_torch.frontend --fleet
N``) end to end, with real child processes behind one shared port: the
cases of tests/test_fleet_supervisor.py on the port, over port mocker
workers, and the fleets of both packages over each other's workers.

Both children serve through one port and the admin endpoint merges their
``/metrics`` and ``/debug/requests`` (the supervisor's own series among
them); a SIGKILLed child is restarted with backoff while its sibling's
streams finish, and its budget chunks are reclaimable; SIGHUP and ``POST
/fleet/roll`` drain and restart every child, and ``POST /fleet/resize``
grows and shrinks the fleet, without a failed request; SIGTERM drains the
fleet and leaves no budget, decision or registration key behind.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import threading
import time

import httpx
import pytest

from procutil import ManagedProcess

GRACE_ENV = {
    "JAX_PLATFORMS": "cpu",
    "OMP_NUM_THREADS": "1",
    # Fast drains and restart backoff, so the file stays quick.
    "DYNTPU_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT": "10",
    "DYNTPU_FLEET_RESTART_BACKOFF_BASE": "0.2",
    "DYNTPU_FLEET_RESTART_BACKOFF_MAX": "1.0",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FleetHarness:
    """store + one mocker worker + a --fleet N frontend, each of the
    package named (``dynamo_tpu_torch`` or ``dynamo_tpu``), with teardown."""

    def __init__(self, n: int = 2, extra_args: list | None = None, itl_ms: str = "1",
                 fleet_pkg: str = "dynamo_tpu_torch", worker_pkg: str = "dynamo_tpu_torch"):
        self.n = n
        self.store_port = _free_port()
        self.store_url = f"tcp://127.0.0.1:{self.store_port}"
        self.fleet_id = f"t{self.store_port}"
        self.procs: list[ManagedProcess] = []
        self.extra_args = extra_args or []
        self.itl_ms = itl_ms
        self.fleet_pkg, self.worker_pkg = fleet_pkg, worker_pkg

    def __enter__(self) -> "FleetHarness":
        try:
            self._start()
        except BaseException:
            self.__exit__()
            raise
        return self

    def _start(self) -> None:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(self.store_port)], name="store",
                               env=GRACE_ENV)
        self.procs.append(store)
        store.wait_for(r"store server: tcp://")
        worker = ManagedProcess(
            ["-m", f"{self.worker_pkg}.worker", "--store-url", self.store_url,
             "--engine", "mocker", "--mocker-speedup", "1", "--mocker-ttft-ms", "1",
             "--mocker-itl-ms", self.itl_ms, "--max-num-seqs", "128"],
            name="worker", env=GRACE_ENV)
        self.procs.append(worker)
        worker.wait_for(r"serving mock-model", 60)
        fleet = ManagedProcess(
            ["-m", f"{self.fleet_pkg}.frontend", "--store-url", self.store_url,
             "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv",
             "--fleet", str(self.n), "--fleet-id", self.fleet_id, *self.extra_args],
            name="fleet", env=GRACE_ENV)
        self.procs.append(fleet)
        self.fleet = fleet
        m = fleet.wait_for(r"fleet: http://127\.0\.0\.1:(\d+) admin http://127\.0\.0\.1:(\d+)",
                           60)
        self.base = f"http://127.0.0.1:{m.group(1)}"
        self.admin = f"http://127.0.0.1:{m.group(2)}"
        fleet.wait_for(r"fleet ready", timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if httpx.get(f"{self.base}/v1/models", timeout=5).json()["data"]:
                return
            time.sleep(0.1)
        raise TimeoutError("model never discovered")

    def __exit__(self, *exc):
        for p in reversed(self.procs):
            p.terminate()
        return False

    def status(self) -> dict:
        return httpx.get(f"{self.admin}/fleet", timeout=5).json()

    def chat(self, text: str, max_tokens: int = 4) -> httpx.Response:
        # A fresh connection per request: SO_REUSEPORT balances connections.
        return httpx.post(f"{self.base}/v1/chat/completions",
                          json={"model": "mock-model", "max_tokens": max_tokens,
                                "messages": [{"role": "user", "content": text}]},
                          headers={"Connection": "close"}, timeout=30)


def served_by_child(metrics: str) -> dict:
    served: dict[str, float] = {}
    for line in metrics.splitlines():
        if line.startswith("dynamo_tpu_http_requests_total{") and 'status="200"' in line:
            wid = line.split('fleet_worker_id="')[1].split('"')[0]
            served[wid] = served.get(wid, 0) + float(line.rsplit(" ", 1)[1])
    return served


@pytest.mark.parametrize("fleet_pkg,worker_pkg", [
    ("dynamo_tpu_torch", "dynamo_tpu_torch"),
    ("dynamo_tpu_torch", "dynamo_tpu"),
    ("dynamo_tpu", "dynamo_tpu_torch"),
], ids=["port_over_port", "port_over_jax", "jax_over_port"])
def test_fleet_serves_both_children_and_aggregates(fleet_pkg, worker_pkg):
    with FleetHarness(n=2, fleet_pkg=fleet_pkg, worker_pkg=worker_pkg) as h:
        for i in range(24):
            r = h.chat(f"hello {i}")
            assert r.status_code == 200, r.text
            assert r.json()["choices"][0]["message"]["content"]
        m = httpx.get(f"{h.admin}/metrics", timeout=10).text
        served = served_by_child(m)
        assert set(served) == {"0", "1"}, f"not all children served: {served}"
        assert sum(served.values()) == 24
        assert 'dynamo_tpu_fleet_workers_alive{fleet_worker_id="supervisor"} 2' in m
        assert "dynamo_tpu_fleet_decision_cache_entries" in m
        ledger = httpx.get(f"{h.admin}/debug/requests", timeout=10).json()
        assert ledger["enabled"] and len(ledger["requests"]) == 24
        assert {r["fleet_worker_id"] for r in ledger["requests"]} == {"0", "1"}
        health = httpx.get(f"{h.admin}/health", timeout=5)
        assert health.status_code == 200 and health.json()["status"] == "ready"
        st = h.status()
        assert st["socket_mode"] in ("reuseport", "inherit")
        assert [w["alive"] for w in st["workers"]] == [True, True]


def test_kill_child_restarts_with_backoff_and_reclaims_budget():
    with FleetHarness(n=2, extra_args=["--global-max-inflight", "16", "--budget-chunk", "4"],
                      itl_ms="50") as h:
        async def drive():
            async with httpx.AsyncClient(timeout=60) as client:
                async def one(i):
                    toks = 0
                    try:
                        async with client.stream(
                            "POST", f"{h.base}/v1/chat/completions",
                            json={"model": "mock-model", "max_tokens": 40, "stream": True,
                                  "ignore_eos": True,
                                  "messages": [{"role": "user", "content": f"s{i}"}]},
                            headers={"Connection": "close"},
                        ) as resp:
                            assert resp.status_code == 200
                            async for line in resp.aiter_lines():
                                if line.startswith("data: ") and '"usage"' in line:
                                    u = json.loads(line[6:]).get("usage")
                                    if u:
                                        toks = u["completion_tokens"]
                        return ("ok", toks)
                    except (httpx.HTTPError, OSError) as e:
                        return (type(e).__name__, toks)

                streams = [asyncio.create_task(one(i)) for i in range(10)]
                await asyncio.sleep(0.6)  # every stream mid-flight (~2 s each)
                victim = next(w["pid"] for w in h.status()["workers"] if w["worker_id"] == 0)
                os.kill(victim, signal.SIGKILL)
                return await asyncio.gather(*streams), victim

        results, victim = asyncio.run(drive())
        oks = [r for r in results if r[0] == "ok" and r[1] == 40]
        assert len(oks) >= 1, results
        assert len(oks) + len([r for r in results if r[0] != "ok"]) == 10
        for r in results:
            assert not (r[0] == "ok" and r[1] != 40), f"silent truncation: {r}"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            w0 = next(w for w in h.status()["workers"] if w["worker_id"] == 0)
            if w0["alive"] and w0["registered"] and w0["pid"] != victim:
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"child 0 never restarted: {h.status()}")
        assert w0["restarts"] >= 1
        assert h.status()["budget_chunks_claimed"] <= 4
        assert h.chat("post-restart").status_code == 200


@pytest.mark.parametrize("how", ["sighup", "roll_rpc"])
def test_rolling_drain_drops_no_request(how):
    with FleetHarness(n=2) as h:
        pids0 = {w["worker_id"]: w["pid"] for w in h.status()["workers"]}
        if how == "sighup":
            h.fleet.proc.send_signal(signal.SIGHUP)
        else:
            r = httpx.post(f"{h.admin}/fleet/roll", timeout=10)
            assert r.status_code == 200 and r.json()["rolling"] is True
        # A connection the kernel handed a draining child just before its
        # listener closed can see the typed drain 503 + Retry-After, which
        # a client retries once; nothing may fail past that.
        failures, rolled = 0, False
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline:
            r = h.chat("during roll", max_tokens=2)
            if r.status_code == 503:
                assert "Retry-After" in r.headers
                r = h.chat("during roll retry", max_tokens=2)
            failures += r.status_code != 200
            st = h.status()
            pids = {w["worker_id"]: w["pid"] for w in st["workers"]}
            if (all(w["alive"] and w["registered"] for w in st["workers"])
                    and all(pids[k] != pids0[k] for k in pids0)):
                rolled = True
                break
            time.sleep(0.1)
        assert rolled, f"rolling restart never completed: {h.status()}"
        assert failures == 0, f"{failures} requests failed (post-retry) during the roll"
        assert h.chat("after roll").status_code == 200


def test_fleet_resize_rpc_grows_and_shrinks_without_failures():
    with FleetHarness(n=1) as h:
        ok = [0]
        stop = threading.Event()
        errors: list[str] = []

        def hammer():
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    r = h.chat(f"resize {i}")
                    if r.status_code == 200:
                        ok[0] += 1
                    elif r.status_code not in (429, 503):
                        errors.append(f"status {r.status_code}")
                except Exception as e:  # noqa: BLE001 — a transport error during resize is the failure this test looks for
                    errors.append(f"{type(e).__name__}: {e}")
                time.sleep(0.02)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            r = httpx.post(f"{h.admin}/fleet/resize", json={"n": 2}, timeout=90)
            assert r.status_code == 200, r.text
            assert r.json()["fleet_size"] == 2 and r.json()["grew"] == 1
            assert h.status()["fleet_size"] == 2

            async def via_actuator():
                from dynamo_tpu_torch.planner.actuate import FleetHttpActuator

                return await FleetHttpActuator(h.admin).fleet_size()

            assert asyncio.run(via_actuator()) == 2
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                st = h.status()
                if all(w["registered"] and w["alive"] for w in st["workers"]):
                    break
                time.sleep(0.2)
            else:
                raise AssertionError(f"grown fleet never converged: {st}")
            r = httpx.post(f"{h.admin}/fleet/resize", json={"n": 1}, timeout=90)
            assert r.status_code == 200, r.text
            assert r.json()["fleet_size"] == 1 and r.json()["shrank"] == 1
            st = h.status()
            assert len(st["workers"]) == 1 and st["workers"][0]["alive"]
            for i in range(6):
                assert h.chat(f"after {i}").status_code == 200
        finally:
            stop.set()
            t.join(10)
        assert not t.is_alive() and not errors, errors[:5]
        assert ok[0] > 0
        for body in ({"n": 0}, {}):
            assert httpx.post(f"{h.admin}/fleet/resize", json=body, timeout=10).status_code == 400


def test_sigterm_drains_fleet_and_clears_shared_state():
    with FleetHarness(n=2, extra_args=["--global-max-inflight", "16",
                                       "--budget-chunk", "4"]) as h:
        for i in range(4):
            assert h.chat(f"warm {i}").status_code == 200
        h.fleet.proc.send_signal(signal.SIGTERM)
        assert h.fleet.proc.wait(40) == 0

        async def probe():
            from dynamo_tpu_torch.runtime.store import connect_store

            store = await connect_store(h.store_url)
            try:
                for prefix in ("budget", "route", "frontends"):
                    assert await store.get_prefix(f"fleet/{h.fleet_id}/{prefix}/") == []
            finally:
                await store.close()

        asyncio.run(asyncio.wait_for(probe(), 30))
