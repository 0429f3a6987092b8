"""The port's planner CLI in its two modes, spawned over port mocker workers
on a TCP store.

- Load-based (``python -m dynamo_tpu_torch.planner --metrics-url ... --
  <worker argv>``): the local connector spawns ``--min-replicas`` port
  workers from the argv after ``--``, they register, and SIGTERM ends the
  planner with exit code 0 and its replicas with it.
- Closed loop with ``--replica-scaling on``: one autoscaled decode worker
  and no prefill engine; the law wants a prefill engine and scales the
  pool up through ``ProcessReplicaLauncher``, which spawns ``python -m
  dynamo_tpu_torch.worker <the worker flags after --> --autoscaler on
  --autoscaler-role prefill`` (here the argv after ``--`` holds the
  flags only: the launcher names the module); the journal records the
  action's ok outcome.
- The local connector scales real processes up and down, oldest kept, as
  the JAX package's does.
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket
import time

from procutil import ManagedProcess

MOCKER = ["--engine", "mocker", "--mocker-ttft-ms", "1", "--mocker-itl-ms", "1",
          "--block-size", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_store():
    port = _free_port()
    store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                            "127.0.0.1", "--port", str(port)], name="store")
    store.wait_for(r"store server: tcp://", 60)
    return store, f"tcp://127.0.0.1:{port}"


async def _keys(url: str, prefix: str) -> list:
    from dynamo_tpu_torch.runtime.store import connect_store

    store = await connect_store(url)
    try:
        return [(e.key, e.value) for e in await store.get_prefix(prefix)]
    finally:
        await store.close()


def wait_keys(url: str, prefix: str, n: int, timeout: float = 60.0) -> list:
    deadline = time.monotonic() + timeout
    while True:
        keys = asyncio.run(_keys(url, prefix))
        if len(keys) == n:
            return keys
        if time.monotonic() > deadline:
            raise TimeoutError(f"{prefix}: {len(keys)} keys, want {n}: {keys}")
        time.sleep(0.1)


def test_load_based_mode_spawns_its_replicas():
    store, url = start_store()
    procs = [store]
    try:
        planner = ManagedProcess([
            "-m", "dynamo_tpu_torch.planner", "--metrics-url", "http://127.0.0.1:9/metrics",
            "--min-replicas", "2", "--adjustment-interval", "60", "--",
            "-m", "dynamo_tpu_torch.worker", "--store-url", url, *MOCKER], name="planner")
        procs.append(planner)
        planner.wait_for(r"dynamo_tpu planner: watching http://127\.0\.0\.1:9/metrics, "
                         r"scaling backend", 60)
        wait_keys(url, "models/dynamo/", 2)
        planner.proc.send_signal(signal.SIGTERM)
        assert planner.proc.wait(60) == 0
        wait_keys(url, "models/dynamo/", 0)
    finally:
        for p in procs:
            p.kill()


def test_closed_loop_scales_a_prefill_replica_up():
    store, url = start_store()
    procs = [store]
    fe_port = _free_port()
    try:
        worker = ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", url,
                                 "--autoscaler", "on", *MOCKER], name="worker")
        procs.append(worker)
        worker.wait_for(r"autoscaled decode worker: serving mock-model", 60)
        fe = ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", url,
                             "--host", "127.0.0.1", "--port", str(fe_port)], name="frontend")
        procs.append(fe)
        fe.wait_for(r"frontend: http://", 60)
        planner = ManagedProcess([
            "-m", "dynamo_tpu_torch.planner", "--operate", "--store-url", url,
            "--metrics-url", f"http://127.0.0.1:{fe_port}/metrics", "--operator-id", "cli",
            "--adjustment-interval", "0.2", "--hysteresis-cycles", "2", "--cooldown", "600",
            "--max-replicas", "2", "--replica-scaling", "on", "--",
            "--store-url", url, *MOCKER], name="planner")
        procs.append(planner)
        planner.wait_for(r"planner \(closed loop\): watching", 60)
        planner.wait_for(r"actuated: prefill replicas 0 → 1", 120)
        workers = wait_keys(url, "autoscaler/dynamo/workers/", 2)
        roles = sorted(json.loads(v)["role"] for _, v in workers)
        assert roles == ["decode", "prefill"]
        journal = [json.loads(v) for _, v in asyncio.run(_keys(url, "planner/cli/actions/"))]
        assert [(e["kind"], e["phase"], e["pool"], e["target"]) for e in journal] == [
            ("replica_scale", "ok", "prefill", 1)]
        planner.proc.send_signal(signal.SIGTERM)
        assert planner.proc.wait(60) == 0
        # The launcher's replica goes with the planner; the first worker stays.
        wait_keys(url, "autoscaler/dynamo/workers/", 1)
    finally:
        for p in reversed(procs):
            p.kill()


def test_local_process_connector_scales_real_processes():
    from dynamo_tpu_torch.planner import LocalProcessConnector

    conn = LocalProcessConnector({"backend": ["-c", "import time; time.sleep(60)"]})
    try:
        conn.set_replicas("backend", 3)
        assert conn.get_replicas("backend") == 3
        pids = [p.pid for p in conn._procs["backend"]]
        conn.set_replicas("backend", 1)
        deadline = time.monotonic() + 5
        while conn.get_replicas("backend") != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert conn.get_replicas("backend") == 1
        assert conn._procs["backend"][0].pid == pids[0]  # oldest survives
    finally:
        conn.shutdown()
    assert conn.get_replicas("backend") == 0
